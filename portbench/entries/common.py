"""What every cell's set-up shares: seeds drawn from ``--seed``, the rows'
streams, the noise each row gets on the device, and the rows that the
output check samples."""
from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one purpose (`path`) of the run seeded `seed`."""
    ss = np.random.SeedSequence([seed % 2 ** 64, *path])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


ROWS, NOISE, CHECK = 1, 2, 3     # the purposes of sub_seed's paths


def row_streams(seed: int, B: int, S: int, device) -> torch.Tensor:
    """(B,) the stream each row takes: every stream B / S rows (one more
    for the first B % S), in an order drawn from `seed`. The set of
    streams is the traffic's own, the same for every seed, so that the
    seed moves the noise and the order and not the work."""
    rng = np.random.default_rng(sub_seed(seed, ROWS))
    return torch.from_numpy(rng.permutation(np.arange(B) % S)).to(device)


def check_rows(seed: int, B: int, n: int) -> np.ndarray:
    """The rows the output check compares, drawn from `seed`: n distinct
    rows of B, sorted."""
    rng = np.random.default_rng(sub_seed(seed, CHECK))
    return np.sort(rng.choice(B, size=min(n, B), replace=False))


def noise_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, NOISE))
    return gen


def rows_of(x: torch.Tensor, row_stream: torch.Tensor) -> torch.Tensor:
    """(B, ...) from (S, ...): each row's copy of its stream."""
    return x.index_select(0, row_stream).contiguous()


def add_noise(x, std, mask, gen):
    """x + std N(0, 1) where `mask` (x's shape without its last axis) is
    set; draws of the whole shape are taken from `gen` either way."""
    n = torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)
    return x + std * n * mask[..., None].to(x.dtype)


def stack_streams(streams, fields):
    """{field: (S, T, ...) numpy} of S generated streams."""
    return {f: np.stack([fi[f] for fi, _ in streams]) for f in fields}


def gt_rows(streams, row_stream, device):
    """(B, T, 3) float64 true positions and (B, 3) gyro0, accel0 (float64)
    of each row's stream."""
    Tsb = torch.from_numpy(np.stack([gt["Tsb"] for _, gt in streams]))
    g0 = torch.from_numpy(np.stack([gt["gyro0"] for _, gt in streams]))
    a0 = torch.from_numpy(np.stack([gt["accel0"] for _, gt in streams]))
    rs = row_stream.cpu()
    return (Tsb.index_select(0, rs).to(device), g0.index_select(0, rs),
            a0.index_select(0, rs))
