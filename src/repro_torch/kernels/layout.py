"""Chunk layouts shared by the kernel ops and the engine.

``chunk_bounds`` cuts a flat N into static [start, stop) slices (the
ops' streaming entry points), ``chunk_points`` builds the engine's padded
``[C, ceil(N/C), D]`` + mask layout (the streamed k-means++ seeding), and
``chunked_sweep`` runs an op per slice and sums the additive statistics.
Padding to tile multiples is not needed: the CUDA kernels loop over K and
D and mask the ragged row tile themselves.
"""
from __future__ import annotations

import torch


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def chunk_bounds(n: int, chunks: int) -> list[tuple[int, int]]:
    """Static [start, stop) slices covering N in ``chunks`` pieces; the last
    piece absorbs the remainder when chunks does not divide N."""
    c = max(1, min(int(chunks), n))
    per = -(-n // c)
    return [(s, min(s + per, n)) for s in range(0, n, per)]


def chunk_points(x: torch.Tensor, chunks: int):
    """[N, D] → ([C, ceil(N/C), D], mask [C, ceil(N/C)]) with zero-padding.

    Row-major: global row i lives at chunk i // per, slot i % per.  The mask
    is 1.0 for real rows, 0.0 for padding.
    """
    n, d = x.shape
    c = max(1, min(int(chunks), n))
    per = -(-n // c)
    xp = torch.zeros((c * per, d), dtype=x.dtype, device=x.device)
    xp[:n] = x
    mask = (torch.arange(c * per, device=x.device) < n).to(torch.float32)
    return xp.reshape(c, per, d), mask.reshape(c, per)


def chunked_sweep(call, n: int, chunks: int):
    """Stream a flat N through statically-sliced op calls.

    ``call(lo, hi)`` runs the op on rows [lo, hi) and returns
    ``(rows, *additive)`` — a per-row output (concatenated across chunks)
    plus additive sufficient statistics (summed in chunk order).
    """
    rows, adds = [], None
    for a, b in chunk_bounds(n, chunks):
        r, *st = call(a, b)
        rows.append(r)
        adds = st if adds is None else [x + y for x, y in zip(adds, st)]
    return (torch.cat(rows, dim=-1), *adds)


def restart_operands(x: torch.Tensor, w: torch.Tensor | None, r: int,
                     batched: bool, op: str):
    """Validate an op's points and row weights against its parameters and
    return the restart-axis views ``(x3 [Rx, N, D], w2 [Rw, N] | None)``.

    Unbatched parameters take x [N, D] and w [N].  Batched parameters
    (leading restart axis R) take points and weights either shared
    ([N, D] / [1, N, D], [N] / [1, N]) or one set per restart ([R, ...]).
    ``w`` None means every row weighs 1 and stays None.
    """
    if x.dtype != torch.float32 or (w is not None
                                    and w.dtype != torch.float32):
        raise TypeError(f"{op}: points and mask must be float32, got "
                        f"{x.dtype} and {None if w is None else w.dtype}")
    if x.ndim not in (2, 3) or (not batched and x.ndim != 2):
        raise ValueError(f"{op}: x must be [N, D] (or [R, N, D] with "
                         f"batched parameters); got {tuple(x.shape)}")
    x3 = x if x.ndim == 3 else x[None]
    if x3.shape[0] not in (1, r):
        raise ValueError(f"{op}: restart axis of x ({x3.shape[0]}) must be "
                         f"1 or {r}")
    if x3.shape[1] < 1:
        raise ValueError(f"{op}: needs at least one row")
    if w is None:
        return x3, None
    if x.device != w.device:
        raise ValueError(f"{op}: points on {x.device}, mask on {w.device}")
    if w.ndim not in (1, 2) or (not batched and w.ndim != 1):
        raise ValueError(f"{op}: mask must be [N] (or [R, N] with batched "
                         f"parameters); got {tuple(w.shape)}")
    w2 = w if w.ndim == 2 else w[None]
    if w2.shape[0] not in (1, r):
        raise ValueError(f"{op}: restart axis of mask ({w2.shape[0]}) must "
                         f"be 1 or {r}")
    if w2.shape[1] != x3.shape[1]:
        raise ValueError(f"{op}: mask has {w2.shape[1]} rows, x has "
                         f"{x3.shape[1]}")
    return x3, w2


def check_rows_contiguous(x3: torch.Tensor, w2: torch.Tensor | None,
                          op: str):
    """The kernels read each row of x and the mask as one contiguous run;
    the restart axis may have any stride (``restart_stride``)."""
    n, d = x3.shape[1:]
    if not (x3.stride(2) == 1 and (n == 1 or x3.stride(1) == d)
            and (w2 is None or w2.stride(1) == 1)):
        raise ValueError(f"{op}: rows of x and mask must be contiguous")


def restart_stride(t: torch.Tensor | None) -> int:
    """Elements between restarts of a [R, ...] view; 0 when shared or
    absent."""
    return 0 if t is None or t.shape[0] == 1 else t.stride(0)
