"""Deterministic, resumable token pipeline (``repro.data.pipeline``).

``batch(step)`` is a pure function of (seed, step): a restart from a
checkpoint needs no data state, and the rows of a batch are generated
independently (row r from its own id), so a rank could make its share
alone.  Two sources: ``synthetic`` (``_hash_tokens``, a learnable
Markov stream) and ``memmap`` (a tokenized uint16 ``.bin`` corpus,
memory-mapped, strided access).

One process makes the whole global batch, rows ``np.arange(B)``, and
moves it to its device -- or, on a mesh with a data axis of ``data``
ranks, rank ``d`` of the data group makes its block of the global
batch, rows ``[d * B / data, (d + 1) * B / data)``, the reference's
batch sharding over ``data`` (``repro/data/pipeline.py:94-115``, each
shard's rows ``np.arange(B)[idx[0]]``); ``B`` must divide by ``data``.
The ``encdec`` / ``vlm`` families' frontend stubs (``_stub_embeds``)
come with each batch, one block per shard as the reference draws them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    kind: str = "synthetic"           # 'synthetic' | 'memmap'
    path: Optional[str] = None        # for memmap: token .bin (uint16)
    vocab_size: int = 256


def _hash_tokens(seed: int, step: int, rows: np.ndarray, seq: int,
                 vocab: int) -> np.ndarray:
    """Deterministic pseudo-corpus with learnable structure, a copy of
    the reference's: a first-order Markov process where, with prob. 7/8,
    the next token is the successor ``(31*prev + 7) % vocab`` and
    otherwise a fresh pseudo-random token.  Stateless in (seed, step,
    row); (len(rows), seq) int64."""
    # per-row starting state, stable across processes by row id
    # (uint64 wraparound is intentional: it's a hash)
    with np.errstate(over="ignore"):
        state = (rows.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
                 + np.uint64(step + 1) * np.uint64(0xBF58476D1CE4E5B9)
                 + np.uint64(seed) * np.uint64(0x94D049BB133111EB))
        toks = np.empty((len(rows), seq), np.int64)
        prev = np.zeros(len(rows), np.int64)
        for t in range(seq):
            state = state * np.uint64(6364136223846793005) \
                + np.uint64(1442695040888963407)
            rnd = state >> np.uint64(33)
            succ = (31 * prev + 7) % vocab
            fresh = (rnd % np.uint64(vocab)).astype(np.int64)
            use_succ = ((rnd >> np.uint64(24)) % np.uint64(8)) != 0
            prev = np.where(use_succ & (t > 0), succ, fresh)
            toks[:, t] = prev
    return toks


class TokenPipeline:
    """Global batches on ``device``, indexed by step."""

    def __init__(self, data_cfg: DataConfig, model_cfg: ModelConfig,
                 shape: ShapeSpec, device="cpu", *, data: int = 1,
                 d: int = 0):
        B = shape.global_batch
        if data < 1 or B % data or not 0 <= d < data:
            raise ValueError(f"a global batch of {B} rows does not cut into "
                             f"{data} data shards (shard {d})")
        self.dc = data_cfg
        self.mc = model_cfg
        self.shape = shape
        self.device = torch.device(device)
        # this data shard's rows of every global batch
        self.rows = np.arange(d * (B // data), (d + 1) * (B // data))
        self._mm = None
        if data_cfg.kind == "memmap":
            if not data_cfg.path:
                raise ValueError("the memmap source needs a path")
            self._mm = np.memmap(data_cfg.path, dtype=np.uint16, mode="r")
        elif data_cfg.kind != "synthetic":
            raise ValueError(f"data kind {data_cfg.kind!r}: 'synthetic' or "
                             "'memmap'")

    def _host_rows(self, step: int, rows: np.ndarray) -> np.ndarray:
        B, S = self.shape.global_batch, self.shape.seq_len
        vocab = min(self.dc.vocab_size, self.mc.vocab_size)
        if self._mm is not None:
            n = len(self._mm) - (S + 1)
            out = np.empty((len(rows), S + 1), np.int64)
            for i, r in enumerate(rows):
                off = (step * B + int(r)) * 13 % n
                out[i] = self._mm[off:off + S + 1].astype(np.int64)
            return out % self.mc.vocab_size
        return _hash_tokens(self.dc.seed, step, rows, S + 1, vocab)

    def batch(self, step: int) -> dict:
        """``{"tokens", "labels"}``: (B, S) int32 each, the labels the
        tokens shifted by one; with ``"src_embeds"`` (B, S, D) under an
        encoder and ``"image_embeds"`` (B, num_image_tokens, D) under a
        vlm config, in the compute dtype.  B is this shard's rows."""
        B, S = len(self.rows), self.shape.seq_len
        data = self._host_rows(step, self.rows)
        t = torch.from_numpy(data.astype(np.int32)).to(self.device)
        out = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        if self.mc.n_encoder_layers:
            out["src_embeds"] = self._embeds(step, (B, S))
        if self.mc.num_image_tokens:
            out["image_embeds"] = self._embeds(
                step, (B, self.mc.num_image_tokens))
        return out

    def _embeds(self, step: int, bn) -> torch.Tensor:
        x = _stub_embeds(self.dc.seed, step, self.rows, bn[1],
                         self.mc.d_model)
        return torch.from_numpy(x).to(self.device).to(
            getattr(torch, self.mc.dtype))


def _stub_embeds(seed: int, step: int, rows: np.ndarray, n: int,
                 d: int) -> np.ndarray:
    """Deterministic frontend stub embeddings (len(rows), n, d) f32, a
    copy of the reference's ``TokenPipeline._stub_embeds``: standard
    normals from a numpy Philox keyed ``seed + 7`` at counter ``[0, 0,
    step, rows[0]]``, times 0.02.  The reference makes one such block per
    shard of the batch, ``rows`` the shard's."""
    rng = np.random.Generator(np.random.Philox(
        key=np.uint64(seed + 7),
        counter=[0, 0, np.uint64(step), np.uint64(int(rows[0]))]))
    return rng.standard_normal((len(rows), n, d), dtype=np.float32) * 0.02
