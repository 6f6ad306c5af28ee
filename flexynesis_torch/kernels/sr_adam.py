"""The stacked rounds' SR-bf16 Adam update in one hand-written CUDA kernel.

``FusedSRAdam`` runs ``ops/sr_adam.py::sr_adam_step`` (its plain version)
over every leaf of a stacked trial round in place, in two launches of
``csrc/sr_adam.cu`` a step, whatever the leaf count: the per-trial norm, then
the update. It replaces no TPU kernel: the JAX package left this step to
XLA, which fuses the chain; eager PyTorch issues several dozen elementwise
launches a leaf, and the kernel takes their place.

The leaves are the optimizer's views (``parallel/stacked.py::flax_layout``):
(K, ...) in the Flax layout, where a transposed weight is a ``.mT`` view of a
tensor in torch's layout. Each leaf is seen as (K, R, C) (``geometry``) with
each operand's strides; m, v and the mask are contiguous in the Flax layout,
as ``sr_adam_init`` and ``parallel/hetero.py`` make them. The hash runs over
the Flax flat index r C + c. The leaf table (``leaf_table``) is written to
the device once per set of leaves, the gradient table (``grad_table``: the
gradients' pointers and strides) every step, each from pinned memory on the
step's stream: a step neither copies from pageable memory nor waits for the
card, and no leaf count is too many for the launches' parameters.

On the card a stacked round with tensor moments takes the kernel
(``fused_update_applies``, ``parallel/trials.py::_Round.step``); 8-bit
moments and CPU leaves keep the plain chain and its copy back. The plan
raises for what the kernel does not take (``check_leaf``: a trial's leaf
whose indices pass 32 bits); there is no fallback. Every step counts
``LAUNCHES_PER_STEP`` in ``FusedSRAdam.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.sr_adam import Q8, SRAdamState, bias_corrections
from .build import current_stream, launcher

TILE = 64          # csrc/sr_adam.cu: a tiled block, 64 x 64 of a trial's (R, C)
FLAT = 4096        # csrc/sr_adam.cu: a flat block, 4,096 consecutive elements
INDEX_LIMIT = 2 ** 31  # a trial's indices and offsets within a leaf are int32
LAUNCHES_PER_STEP = 2
LEAF_FIELDS = 16   # int64 a row of the leaf table (csrc/sr_adam.cu's Leaf)
(F_P, F_M, F_V, F_MASK, F_TILE_START, F_TILES, F_ROWS, F_COLS, F_TILES_C, F_P_SK, F_P_SR,
 F_P_SC, F_FLAGS, F_INDEX) = range(14)
GRAD_FIELDS = 4    # int64 a row of the gradient table (csrc/sr_adam.cu's Grad)


class _StepArgs(ctypes.Structure):
    """csrc/sr_adam.cu's ``Step``."""
    _fields_ = [("leaves", ctypes.c_void_p), ("grads", ctypes.c_void_p),
                ("partials", ctypes.c_void_p),
                ("ticket", ctypes.c_void_p), ("scale", ctypes.c_void_p),
                ("lr", ctypes.c_void_p), ("seed", ctypes.c_void_p),
                ("n_tiles", ctypes.c_longlong), ("tiles_per_trial", ctypes.c_longlong),
                ("n_leaves", ctypes.c_int), ("K", ctypes.c_int), ("lr_stride", ctypes.c_int),
                ("seed_stride", ctypes.c_int), ("count", ctypes.c_uint),
                *((name, ctypes.c_float) for name in
                  ("b1", "b2", "one_m_b1", "one_m_b2", "b1c", "b2c", "eps", "clip"))]



def _f32(v: float) -> float:
    return float(np.float32(v))


def geometry(shape: Sequence[int]) -> tuple:
    """(R, C) of one trial's leaf of Flax shape (K, *s): the last axis is C,
    the others R (1 for a vector or a scalar)."""
    inner = tuple(int(d) for d in shape[1:])
    if not inner:
        return 1, 1
    return math.prod(inner[:-1]), inner[-1]


def rc_strides(t: torch.Tensor, R: int, C: int) -> Optional[tuple]:
    """(trial, row, column) strides of ``t`` (K, *s) seen as (K, R, C), or
    None where its strides do not merge the leading inner axes."""
    st = t.stride()
    if t.dim() == 1:
        return st[0], 0, 0
    if t.dim() == 2:
        return st[0], 0, st[1]
    if t.dim() == 3:
        return st
    try:
        return t.view(t.shape[0], R, C).stride()
    except RuntimeError:
        return None


def leaf_tiles(R: int, C: int, p_strides: tuple) -> tuple:
    """(tiles_c, tiles a trial): flat blocks (tiles_c 0) where p is
    contiguous in the Flax layout (the stride of an axis of one element
    does not count), else 64 x 64 tiles."""
    _, sr, sc = p_strides
    if (C == 1 or sc == 1) and (R == 1 or sr == C):
        return 0, -(-(R * C) // FLAT)
    tiles_c = -(-C // TILE)
    return tiles_c, -(-R // TILE) * tiles_c


def leaf_table(shapes, p_strides) -> np.ndarray:
    """The leaf table's geometry columns ((n, LEAF_FIELDS) int64; pointers,
    types and indices left 0) of leaves of Flax shapes ``shapes`` (each with
    an element) with p's strides: each leaf's tiles and its first tile in a
    trial's run of tiles."""
    table = np.zeros((len(shapes), LEAF_FIELDS), np.int64)
    start = 0
    for row, shape, ps in zip(table, shapes, p_strides):
        R, C = geometry(shape)
        tiles_c, tiles = leaf_tiles(R, C, ps)
        row[[F_TILE_START, F_TILES, F_ROWS, F_COLS, F_TILES_C, F_P_SK, F_P_SR, F_P_SC]] = (
            start, tiles, R, C, tiles_c, *ps)
        start += tiles
    return table


def tiles_per_trial(table: np.ndarray) -> int:
    return int(table[:, F_TILES].sum())


def check_leaf(i: int, R: int, C: int, p_strides: tuple) -> None:
    """Raise where one trial's (R, C) leaf with p's strides needs 64-bit
    indices in the kernel: its elements with the overhang of its last flat
    block, or of its last row and column of tiles, and p's largest offset
    within a trial. The trial axis is 64-bit and sets no limit."""
    tiles_c, _ = leaf_tiles(R, C, p_strides)
    reach = (R + TILE) * (C + TILE) if tiles_c else R * C + FLAT
    _, sr, sc = p_strides
    if reach > INDEX_LIMIT or (R - 1) * sr + (C - 1) * sc >= INDEX_LIMIT:
        raise ValueError(f"leaf {i}: a trial's ({R}, {C}) with strides {p_strides} needs "
                         "indices beyond int32 in the kernel")


def grad_table(grads: Sequence[Optional[torch.Tensor]], geom: Sequence[tuple],
               out: np.ndarray) -> list:
    """Write the gradient table's rows into ``out`` ((n, GRAD_FIELDS)
    int64): each gradient's pointer (0 for None, a zero gradient) and its
    (trial, row, column) strides seen as (K, R, C) with ``geom``'s (R, C).
    Returns the contiguous copies made of gradients whose strides do not
    merge; they must live until the kernel has read them."""
    copies, rows = [], []
    for g, (R, C) in zip(grads, geom):
        if g is None:
            rows.append((0, 0, 0, 0))
            continue
        st = rc_strides(g, R, C)
        if st is None:  # strides that do not merge: a contiguous copy
            g = g.contiguous()
            copies.append(g)
            st = rc_strides(g, R, C)
        if (R - 1) * st[1] + (C - 1) * st[2] >= INDEX_LIMIT:
            raise ValueError(f"gradient strides {g.stride()}: offsets within a trial beyond int32")
        rows.append((g.data_ptr(), *st))
    out[:] = rows
    return copies


def fma_rn(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as the kernel's ``__fmaf_rn`` (and
    XLA) compute it, in plain PyTorch. The plain chain's float64 route
    (``ops/sr_adam.py::_fma``: the product exact, the sum rounded to float64,
    then to float32) rounds twice where the float64 sum lands exactly halfway
    between two floats and the exact sum does not; there the sign of the
    sum's error (TwoSum) picks the side. A chain with this in place of
    ``_fma`` gives the kernel's bits, which shows that the kernel parts from
    the plain chain only by such double roundings."""
    p = a.double() * (b.double() if torch.is_tensor(b) else b)
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    f = s.float()
    fd = f.double()
    other = torch.nextafter(f, torch.where(s > fd, math.inf, -math.inf).float())
    tie = (s == (fd + other.double()) * 0.5) & (err != 0)
    side = torch.where(err > 0, torch.maximum(f, other), torch.minimum(f, other))
    return torch.where(tie, side, f)


def global_norm_f64(tree: List[torch.Tensor], trial_axis: bool = False) -> torch.Tensor:
    """The kernel's global norm in plain PyTorch: the float32 squares
    summed in float64, the sum rounded to float32, then its float32 square
    root; per trial with ``trial_axis``. ``ops/sr_adam.py::global_norm_f32``
    sums in float32, so where the clip is active the two clip scales may part
    in the last place; a chain with this in its place (and ``fma_rn``) gives
    the kernel's bits but where two float64 sums in different orders round
    to different float32 values."""
    if trial_axis:
        total = sum(x.float().square().double().flatten(1).sum(1) for x in tree)
    else:
        total = sum(x.float().square().double().sum() for x in tree)
    return torch.sqrt(total.float())


def fused_update_applies(params: List[torch.Tensor], state: SRAdamState) -> bool:
    """Whether these leaves take the kernel: CUDA leaves with tensor moments
    (the "mirror" type). 8-bit moments (``Q8``) and CPU leaves take the plain
    chain."""
    return params[0].is_cuda and not any(isinstance(x, Q8) for x in (*state.m, *state.v))


def _as_vector(x, dtype, device, K: int, what: str):
    """(a device tensor of ``dtype`` holding one value or one per trial, its
    stride): a Python number becomes a device tensor without a host copy."""
    if not torch.is_tensor(x):
        x = torch.full((), x, dtype=dtype, device=device)
    if x.device != device:
        x = x.to(device)
    if x.dtype != dtype:
        x = x.to(dtype)
    if x.numel() == 1:
        return x, 0
    if x.dim() != 1 or x.shape[0] != K:
        raise ValueError(f"{what} holds {tuple(x.shape)} values for {K} trials")
    return x, x.stride(0)


class FusedSRAdam:
    """The kernel's plan for one set of leaves: the leaf table on the
    device, the workspace (per-block partial sums, the ticket, the trials'
    clip scales) and the launch arguments. Built once for a round's leaves,
    moments and masks; ``step`` updates them in place. ``launches`` counts
    the kernel's launches in the process."""

    launches = 0

    def __init__(self, params: List[torch.Tensor], state: SRAdamState,
                 masks: Optional[List[Optional[torch.Tensor]]] = None):
        if not params:
            raise ValueError("no leaves")
        if any(isinstance(x, Q8) for x in (*state.m, *state.v)):
            raise TypeError("the kernel takes tensor moments; 8-bit moments keep the plain chain")
        masks = [None] * len(params) if masks is None else list(masks)
        dev = params[0].device
        if dev.type != "cuda":
            raise ValueError(f"no kernel for device {dev}")
        K = params[0].shape[0] if params[0].dim() else 0
        self.params, self.m, self.v, self.masks = list(params), list(state.m), list(state.v), masks
        self.device, self.K = dev, K
        self.shapes = [tuple(p.shape) for p in params]
        dense_masks, p_strides, keep = [], [], []
        for i, (p, m, v, k) in enumerate(zip(params, state.m, state.v, masks)):
            if p.dim() == 0 or p.shape[0] != K:
                raise ValueError(f"leaf {i} {tuple(p.shape)} has no trial axis of {K}")
            for name, t in (("leaf", p), ("m", m), ("v", v)):
                if t.device != dev:
                    raise ValueError(f"leaf {i}: {name} is on {t.device}, the leaves on {dev}")
                if t.dtype not in (torch.bfloat16, torch.float32):
                    raise TypeError(f"leaf {i}: {name} is {t.dtype}; the kernel takes bfloat16 "
                                    "or float32")
            for name, t in (("m", m), ("v", v)):
                if t.shape != p.shape or not t.is_contiguous():
                    raise ValueError(f"leaf {i}: {name} must be contiguous of the leaf's shape "
                                     f"{tuple(p.shape)}")
            if k is not None:  # a broadcasting mask is laid out in full once
                k = torch.broadcast_to(k.to(dev, torch.float32), p.shape).contiguous()
            dense_masks.append(k)
            R, C = geometry(p.shape)
            ps = rc_strides(p, R, C)
            if ps is None:
                raise ValueError(f"leaf {i}: strides {p.stride()} of {tuple(p.shape)} do not "
                                 "merge into (K, R, C); the update is in place")
            if R * C:
                check_leaf(i, R, C, ps)
            p_strides.append(ps)
            if R * C:
                keep.append(i)
        if not keep:
            raise ValueError("no leaf holds an element")
        self.rows = keep  # the leaves in the table, in tree order
        self.geom = [geometry(self.shapes[i]) for i in keep]
        table = leaf_table([self.shapes[i] for i in keep], [p_strides[i] for i in keep])
        for row, i in zip(table, keep):
            row[[F_P, F_M, F_V]] = (params[i].data_ptr(), state.m[i].data_ptr(),
                                    state.v[i].data_ptr())
            row[F_MASK] = 0 if dense_masks[i] is None else dense_masks[i].data_ptr()
            row[F_FLAGS] = ((params[i].dtype == torch.bfloat16)
                            | (state.m[i].dtype == torch.bfloat16) << 1
                            | (state.v[i].dtype == torch.bfloat16) << 2)
            row[F_INDEX] = i
        self.n_tiles = K * tiles_per_trial(table)
        if self.n_tiles >= INDEX_LIMIT:
            raise ValueError(f"{self.n_tiles} blocks; a launch takes under 2^31")
        self._dense_masks = dense_masks  # the table points into them
        # written once, from pinned memory and asynchronously: no host wait
        self._table = torch.from_numpy(table).pin_memory().to(dev, non_blocking=True)
        self._partials = torch.empty(self.n_tiles, dtype=torch.float64, device=dev)
        self._ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        self._scale = torch.empty(K, dtype=torch.float32, device=dev)
        self._grad_table = torch.empty((len(keep), GRAD_FIELDS), dtype=torch.int64, device=dev)
        self._step = _StepArgs(
            leaves=self._table.data_ptr(), grads=self._grad_table.data_ptr(),
            partials=self._partials.data_ptr(),
            ticket=self._ticket.data_ptr(), scale=self._scale.data_ptr(),
            n_tiles=self.n_tiles, tiles_per_trial=tiles_per_trial(table), n_leaves=len(keep),
            K=K)

    def serves(self, params, state: SRAdamState, masks=None) -> bool:
        """Whether this plan was built for these very leaves, moments and
        masks."""
        masks = [None] * len(params) if masks is None else masks
        return (len(params) == len(self.params)
                and all(a is b for a, b in zip(params, self.params))
                and all(a is b for a, b in zip(state.m, self.m))
                and all(a is b for a, b in zip(state.v, self.v))
                and all(a is b for a, b in zip(masks, self.masks)))

    def step(self, state: SRAdamState, grads: List[Optional[torch.Tensor]], lr, seed, *,
             grad_clip: float = 1.0, b1: float = 0.9, b2: float = 0.999,
             eps: float = 1e-8) -> SRAdamState:
        """One step of every leaf in place; returns the state with the count
        advanced (the same moment tensors). ``grads`` in the leaves' order
        and Flax layout, float32, None for a zero gradient; ``lr`` (float32)
        and ``seed`` (the SR seeds, uint32 values as int64) one value or one
        per trial."""
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} leaves")
        dev, K = self.device, self.K
        count = state.count + 1
        b1c, b2c = bias_corrections(count, b1, b2)
        mine = [grads[i] for i in self.rows]
        for i, g in zip(self.rows, mine):
            if g is None:
                continue
            if tuple(g.shape) != self.shapes[i]:
                raise ValueError(f"gradient {i} {tuple(g.shape)} for a leaf {self.shapes[i]}")
            if g.dtype != torch.float32 or g.device != dev:
                raise TypeError(f"gradient {i} is {g.dtype} on {g.device}; the kernel takes "
                                f"float32 on {dev}")
        # pinned rows, copied on the stream: the host allocator keeps the
        # block until the copy has run, so the host never waits for it
        rows = torch.empty(tuple(self._grad_table.shape), dtype=torch.int64, pin_memory=True)
        copies = grad_table(mine, self.geom, rows.numpy())  # alive until the launch
        self._grad_table.copy_(rows, non_blocking=True)
        lr, lr_stride = _as_vector(lr, torch.float32, dev, K, "lr")
        seed, seed_stride = _as_vector(seed, torch.int64, dev, K, "seed")
        sa = self._step
        sa.lr, sa.lr_stride = lr.data_ptr(), lr_stride
        sa.seed, sa.seed_stride = seed.data_ptr(), seed_stride
        sa.count = count & 0xFFFFFFFF
        sa.b1, sa.b2 = _f32(b1), _f32(b2)
        sa.one_m_b1, sa.one_m_b2 = _f32(1.0 - b1), _f32(1.0 - b2)
        sa.b1c, sa.b2c, sa.eps, sa.clip = b1c, b2c, _f32(eps), _f32(grad_clip)
        rc = _launcher()(ctypes.addressof(sa), current_stream(dev))
        if rc != 0:
            raise RuntimeError(f"sr_adam kernel launch failed: CUDA error {rc} "
                               f"({len(self.rows)} leaves, K={K}, {self.n_tiles} blocks)")
        FusedSRAdam.launches += LAUNCHES_PER_STEP
        return SRAdamState(state.m, state.v, count)


@functools.cache
def _launcher():
    """csrc/sr_adam.cu's ``sr_adam_step``, built at first use, once the
    library's structs are found to have the sizes of their ctypes mirrors."""
    sizes = (ctypes.c_longlong * 3)()
    launcher("sr_adam", "sr_adam_struct_sizes", [ctypes.c_void_p])(sizes)
    want = (ctypes.sizeof(_StepArgs), GRAD_FIELDS * 8, LEAF_FIELDS * 8)
    if tuple(sizes) != want:
        raise RuntimeError(f"csrc/sr_adam.cu's structs take {tuple(sizes)} bytes, its wrapper's "
                           f"{want}")
    return launcher("sr_adam", "sr_adam_step", [ctypes.c_void_p] * 2)
