"""Named fabric presets and the two-level (intra, inter) fabric model.

Counterpart of ``oktopk_tpu/comm/fabric.py:1-115``, with the port's own
copy of ``FabricCoefficients`` (``oktopk_tpu/autotune/calibrate.py:38-48``).
A preset is the JAX package's projection convention ``(alpha seconds per
message round, bandwidth GB/s per worker)``: ``ici`` a TPU slice's
conservative ring bandwidth, ``dcn`` a pod-to-pod data-center network,
``gbe`` the 1.25 GB/s-class Ethernet of the reference's cluster. They are
planning constants of that cost model, not measurements of any link the
port runs on.

``TwoLevelFabric`` pairs an intra-pod link with an inter-pod link: the
topology the hierarchical collective (``collectives/hierarchical.py``)
composes over, dense inside a pod and sparse across pods.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

#: Selection gamma (seconds per element) the JAX package's planner uses
#: for every sparse candidate when it plans from a preset.
PLAN_SELECT_GAMMA = 2e-10


@dataclasses.dataclass(frozen=True)
class FabricCoefficients:
    """Alpha-beta coefficients of one fabric (measured, default or from a
    preset)."""

    alpha: float                   # seconds per message round
    beta: float                    # seconds per element
    source: str = "default"        # "measured" | "default" | "injected"
    nsamples: int = 0
    residual: float = 0.0          # rms relative fit error over the samples

    def as_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class FabricPreset:
    """One named link: alpha-beta coefficients in projection convention."""

    name: str
    alpha_s: float            # seconds per message round
    gbps: float               # effective GB/s per worker

    def beta_elem(self, elem_bytes: int = 4) -> float:
        """Seconds per transmitted element of ``elem_bytes`` bytes."""
        return float(elem_bytes) / (self.gbps * 1e9)

    def coefficients(self, elem_bytes: int = 4) -> FabricCoefficients:
        """This preset as ``FabricCoefficients`` (the planning substitute
        for a measured probe fit)."""
        return FabricCoefficients(alpha=self.alpha_s,
                                  beta=self.beta_elem(elem_bytes),
                                  source=f"preset:{self.name}")


FABRIC_PRESETS: Dict[str, FabricPreset] = {
    "ici": FabricPreset("ici", 1e-6, 100.0),
    "dcn": FabricPreset("dcn", 10e-6, 25.0),
    "gbe": FabricPreset("gbe", 50e-6, 1.25),
}


def get_fabric(name: str) -> FabricPreset:
    try:
        return FABRIC_PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown fabric preset {name!r}; "
                         f"available: {sorted(FABRIC_PRESETS)}") from None


def alpha_beta_table() -> Dict[str, Tuple[float, float]]:
    """``{name: (alpha_s, gbps)}``, a fresh dict on every call."""
    return {n: (p.alpha_s, p.gbps) for n, p in FABRIC_PRESETS.items()}


@dataclasses.dataclass(frozen=True)
class TwoLevelFabric:
    """An (intra-pod, inter-pod) link pair for hierarchical planning."""

    intra: FabricPreset
    inter: FabricPreset

    @property
    def name(self) -> str:
        return f"{self.intra.name}+{self.inter.name}"


def two_level(inter: Union[str, FabricPreset] = "dcn",
              intra: Union[str, FabricPreset] = "ici") -> TwoLevelFabric:
    """Build a :class:`TwoLevelFabric`; string arguments name presets."""
    if isinstance(inter, str):
        inter = get_fabric(inter)
    if isinstance(intra, str):
        intra = get_fabric(intra)
    return TwoLevelFabric(intra=intra, inter=inter)


def resolve_two_level(
        spec: Union[str, FabricPreset, TwoLevelFabric]) -> TwoLevelFabric:
    """A fabric override as a :class:`TwoLevelFabric`: a bare preset (or
    its name) is the inter edge, with ``ici`` inside each pod."""
    if isinstance(spec, TwoLevelFabric):
        return spec
    if isinstance(spec, FabricPreset):
        return TwoLevelFabric(intra=FABRIC_PRESETS["ici"], inter=spec)
    return TwoLevelFabric(intra=FABRIC_PRESETS["ici"],
                          inter=get_fabric(spec))
