"""Signal-fidelity taps and wire-byte budgets of the port."""
