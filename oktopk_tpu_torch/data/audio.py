"""AN4 audio: WAV -> log spectrogram -> padded CTC batches.

Counterpart of ``oktopk_tpu/data/audio.py`` (the reference's audio
loader, LSTM/dl_trainer.py:420-446): stdlib ``wave`` and a numpy STFT
(20 ms Hamming window, 10 ms hop at 16 kHz: 161 frequency bins),
per-utterance normalisation, the character labels for CTC (blank at 0),
batches padded to a fixed frame count. The same files and seed give the
same batches as the JAX package."""

from __future__ import annotations

import os
import wave
from typing import Dict, Iterator, List, Tuple

import numpy as np

AN4_LABELS = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ "   # blank at index 0
SAMPLE_RATE = 16000
WINDOW = 320        # 20 ms
HOP = 160           # 10 ms
N_FREQ = WINDOW // 2 + 1    # 161


def read_wav(path: str) -> np.ndarray:
    with wave.open(path, "rb") as w:
        data = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    return data.astype(np.float32) / 32768.0


def log_spectrogram(audio: np.ndarray) -> np.ndarray:
    """[N_FREQ, T] log magnitude STFT with per-utterance normalisation."""
    if len(audio) < WINDOW:
        audio = np.pad(audio, (0, WINDOW - len(audio)))
    n_frames = 1 + (len(audio) - WINDOW) // HOP
    idx = (np.arange(WINDOW)[None, :]
           + HOP * np.arange(n_frames)[:, None])
    frames = audio[idx] * np.hamming(WINDOW)
    spec = np.abs(np.fft.rfft(frames, axis=1)).T       # [N_FREQ, T]
    spec = np.log1p(spec)
    mean, std = spec.mean(), spec.std() + 1e-6
    return ((spec - mean) / std).astype(np.float32)


def text_to_labels(text: str) -> List[int]:
    table = {c: i for i, c in enumerate(AN4_LABELS)}
    return [table[c] for c in text.upper() if c in table]


def load_manifest(manifest_path: str) -> List[Tuple[str, str]]:
    """CSV manifest lines: wav_path,transcript_path (the reference's
    manifest format)."""
    base = os.path.dirname(manifest_path)
    items = []
    with open(manifest_path) as f:
        for line in f:
            wav, txt = line.strip().split(",")[:2]
            if not os.path.isabs(wav):
                wav = os.path.join(base, wav)
                txt = os.path.join(base, txt)
            items.append((wav, txt))
    return items


def an4_iterator(manifest_path: str, batch_size: int, max_frames: int = 400,
                 max_label_len: int = 80, seed: int = 0,
                 shuffle: bool = True) -> Iterator[Dict]:
    items = load_manifest(manifest_path)
    rng = np.random.RandomState(seed)
    while True:
        order = rng.permutation(len(items)) if shuffle else range(len(items))
        batch: List[int] = []
        for j in order:
            batch.append(j)
            if len(batch) < batch_size:
                continue
            spect = np.zeros((batch_size, N_FREQ, max_frames, 1), np.float32)
            spect_lengths = np.zeros((batch_size,), np.int32)
            labels = np.zeros((batch_size, max_label_len), np.int32)
            label_lengths = np.zeros((batch_size,), np.int32)
            for b, jj in enumerate(batch):
                wav, txt = items[jj]
                s = log_spectrogram(read_wav(wav))
                t = min(s.shape[1], max_frames)
                spect[b, :, :t, 0] = s[:, :t]
                spect_lengths[b] = t
                with open(txt) as f:
                    lab = text_to_labels(f.read().strip())[:max_label_len]
                labels[b, :len(lab)] = lab
                label_lengths[b] = len(lab)
            yield {"spect": spect, "spect_lengths": spect_lengths,
                   "labels": labels, "label_lengths": label_lengths}
            batch = []
