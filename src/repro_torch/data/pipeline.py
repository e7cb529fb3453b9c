"""Deterministic, checkpointable data pipeline; port of
`repro.data.pipeline`.

Batches are a pure function of (seed, step): ``batch_at(step)`` always
returns the same arrays, so the iterator's state is just the step
counter and restarts are exact. The synthetic LM stream generates
structured token sequences (a noisy periodic source, not uniform noise)
so smoke-training shows a falling loss. The generator is the
reference's numpy code, so its batches equal the reference's bit for
bit; `TokenIterator` puts them on its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class SyntheticLMDataset:
    """Structured synthetic LM tokens: mixture of periodic + markov noise."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    embed_dim: int = 0  # for input_mode="embeds" archs: emit frame embeddings

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        # periodic skeleton (learnable structure) + noise substitutions
        period = 3 + (np.arange(B) % 5)
        base = (np.arange(S)[None, :] // 1 % period[:, None]) \
            * (V // 8) % max(V - 2, 1) + 1
        noise = rng.integers(1, V, size=(B, S))
        mask = rng.random((B, S)) < 0.15
        tokens = np.where(mask, noise, base).astype(np.int32)
        labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
        out = {"labels": labels}
        if self.embed_dim:
            emb_rng = np.random.default_rng(
                np.random.SeedSequence([self.seed + 7, step]))
            # frame/patch embeddings stub: token-conditioned gaussians
            proto = emb_rng.standard_normal((64, self.embed_dim))
            out["embeds"] = (proto[tokens % 64] * 0.05).astype(np.float32)
        else:
            out["tokens"] = tokens
        return out


class TokenIterator:
    """Checkpointable iterator over a SyntheticLMDataset, yielding tensors
    on ``device`` (CUDA unless the caller passes ``device="cpu"``): token
    ids and labels as int64, embeddings as float32."""

    def __init__(self, ds: SyntheticLMDataset, start_step: int = 0,
                 device: Union[None, str, torch.device] = None):
        self.ds = ds
        self.step = start_step
        self.device = resolve_device(device)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        batch = self.ds.batch_at(self.step)
        self.step += 1
        return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                    else v).to(self.device)
                for k, v in batch.items()}

    # ---- checkpointable state ----
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.ds.seed}

    def load_state_dict(self, d: dict) -> None:
        if d["seed"] != self.ds.seed:
            raise ValueError("dataset seed mismatch on restore")
        self.step = int(d["step"])


def for_config(cfg: ModelConfig, shape: ShapeConfig,
               seed: int = 0) -> SyntheticLMDataset:
    return SyntheticLMDataset(
        vocab_size=cfg.vocab_size,
        seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        seed=seed,
        embed_dim=cfg.d_model if cfg.input_mode == "embeds" else 0,
    )
