"""Training data (counterpart of ``topiaxl/pipelines/data.py``).

* ``TokenShardDataset``: sharded .npz files of precomputed (x tokens, y
  conditioning tokens), memory-mapped reads, a deterministic shuffle per
  epoch, and a per-host slice (host 0 of 1 by default: the port runs on
  one device).
* ``synthetic_batches``: an endless seeded random stream for smoke runs
  and measurement.
* ``prefetch_to_device``: copies host batches to the device through
  pinned memory on a side stream, ``depth`` batches ahead, so the copy
  overlaps the current step.
* ``encode_assets``: PrimX params -> normalised DiT tokens through the
  VAE encoder and the latent statistics (dataset preparation), the
  inverse of ``pipelines/infer.py:decode_primx``.
"""

from __future__ import annotations

import glob as globlib
from typing import Iterator

import numpy as np
import torch


class TokenShardDataset:
    """Reads shards saved as npz with arrays 'x' [M, N, C] and 'y'
    [M, My, Cy]."""

    def __init__(self, pattern: str, batch_size: int, shuffle_seed: int = 0,
                 host_id: int = 0, host_count: int = 1):
        self.files = sorted(globlib.glob(pattern))
        if not self.files:
            raise FileNotFoundError(f"no shards match {pattern}")
        self.batch_size = batch_size
        self.seed = shuffle_seed
        self.host_id = host_id
        self.host_count = host_count
        self._index = []  # (file_idx, row)
        for fi, f in enumerate(self.files):
            with np.load(f, mmap_mode="r") as z:
                rows = z["x"].shape[0]
            self._index.extend((fi, r) for r in range(rows))

    def __len__(self) -> int:
        return len(self._index)

    def epoch(self, epoch: int) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(len(self._index))
        order = order[self.host_id::self.host_count]
        opened: dict = {}
        try:
            for b in range(len(order) // self.batch_size):
                sel = order[b * self.batch_size:(b + 1) * self.batch_size]
                xs, ys = [], []
                for o in sel:
                    fi, r = self._index[o]
                    if fi not in opened:
                        opened[fi] = np.load(self.files[fi], mmap_mode="r")
                    xs.append(np.asarray(opened[fi]["x"][r]))
                    ys.append(np.asarray(opened[fi]["y"][r]))
                yield {"x": np.stack(xs), "y": np.stack(ys)}
        finally:
            for z in opened.values():
                z.close()


def synthetic_batches(batch_size: int, seq: int = 2048, ch: int = 68,
                      cond_seq: int = 1370, cond_ch: int = 768,
                      seed: int = 0, shape: tuple | None = None
                      ) -> Iterator[dict]:
    """x [B, seq, ch] (or [B, *shape]: one sample's shape, such as a
    TRELLIS latent grid's) and y [B, cond_seq, cond_ch], standard
    normal."""
    rng = np.random.default_rng(seed)
    x_shape = (batch_size, *(shape or (seq, ch)))
    while True:
        yield {
            "x": rng.standard_normal(x_shape).astype("f"),
            "y": rng.standard_normal((batch_size, cond_seq, cond_ch)).astype("f"),
        }


def prefetch_to_device(it: Iterator[dict], device, depth: int = 2
                       ) -> Iterator[dict]:
    """Yield each host batch as device tensors, ``depth`` batches ahead.
    On a CUDA device the copies come from pinned memory on a side stream,
    and the consumer's stream waits for them before use."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    buf: list = []

    def put(batch):
        if not cuda:
            return {k: torch.from_numpy(np.asarray(v)) for k, v in
                    batch.items()}, None
        with torch.cuda.stream(stream):
            out = {k: torch.from_numpy(np.asarray(v)).pin_memory().to(
                device, non_blocking=True) for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def take():
        out, done = buf.pop(0)
        if done is not None:
            torch.cuda.current_stream(device).wait_event(done)
            for t in out.values():
                t.record_stream(torch.cuda.current_stream(device))
        return out

    for batch in it:
        buf.append(put(batch))
        if len(buf) > depth:
            yield take()
    while buf:
        yield take()


def normalize_payload(payload: torch.Tensor, dim_feat: int = 6
                      ) -> torch.Tensor:
    """Payloads [N, C * S^3] (channel-major) -> the VAE's input [N, C, S,
    S, S]: sdf * 5, the other channels * 2 - 1 (the reference's
    normalisation; ``decode_primx`` inverts it)."""
    N = payload.shape[0]
    S = round((payload.shape[-1] // dim_feat) ** (1 / 3))
    vol = payload.reshape(N, dim_feat, S, S, S)
    return torch.cat([vol[:, :1] * 5.0, vol[:, 1:] * 2.0 - 1.0], dim=1)


@torch.no_grad()
def encode_assets(vae, srt, payload, latent_mean, latent_std,
                  latent_nf: float = 1.0,
                  generator: torch.Generator | None = None,
                  dim_feat: int = 6) -> np.ndarray:
    """PrimX params (srt [N, 4], payload [N, C * S^3], tensors or arrays)
    -> normalised DiT tokens [N, 4 + L] as numpy: the payload normalised
    and encoded on the VAE's device, the posterior's mode (or a draw from
    ``generator``), the latent flattened channels-last as the JAX package
    flattens it, ``[srt | latent]`` normalised by the latent statistics on
    the host, as the JAX package does."""
    dev = next(vae.parameters()).device
    payload = torch.as_tensor(payload).to(dev, torch.float32)
    posterior = vae.encode(normalize_payload(payload, dim_feat))
    z = posterior.mode() if generator is None else posterior.sample(generator)
    lat = torch.movedim(z, 1, -1).reshape(z.shape[0], -1).float().cpu().numpy()
    srt = torch.as_tensor(srt).float().cpu().numpy()
    tokens = np.concatenate([srt, lat], axis=-1)
    return ((tokens - np.asarray(latent_mean)) / np.asarray(latent_std)
            * latent_nf)
