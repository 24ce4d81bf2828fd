"""The SSD intra-chunk block of Mamba-2 (B4): the hand-written CUDA kernel,
its wrapper, its launch plan, and its plain PyTorch version.

The kernel (``csrc/ssd_chunk_sm90.cu``) replaces the JAX reference's Pallas
TPU kernel ``repro/kernels/ssd_chunk.py::ssd_intra_pallas`` and keeps its
signature: ``cc, bc (BC, Q, N)`` shared across heads, ``acum (BC, H, Q)``
cumulative log decays, ``xd (BC, H, Q, P)``; it returns

    y[g, h, i] = sum_{j <= i} (cc[g, i] . bc[g, j]) exp(acum[g, h, i] -
                 acum[g, h, j]) xd[g, h, j]

in fp32, both products in 3xTF32 on Hopper's tensor cores, the C.B^T
scores formed once for a group of heads.  The source's header says what
bounds it on the H100 and how it is built; ``launch_plan`` says how a
launch is cut into blocks.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  ``ssd_intra.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as _build

MAX_P = 64
MAX_N = 128          # the score product's k, in one stage
T = 64               # rows of a row tile, columns of a column tile
HEADS = (2, 4)       # heads a block: one or two per warpgroup
THREADS = 256        # two warpgroups
SMS = 132            # the H100 SXM's SMs
SMEM_MAX = 232448    # dynamic shared memory a block may use (bytes)
# two stages of 64 x 128 fp32 in tf32 hi and lo (B_j, or two heads' x^T),
# the block's C_i the same, the fp32 score tile (rows of 68 floats), the
# column decays of two stages and two heads (2 x 64 + 4 floats each), the
# row decays of four heads, and the slack that aligns the tiles to 1,024
# bytes
SMEM = 3 * 2 * T * MAX_N * 4 + T * (T + 4) * 4 + 2 * 2 * (2 * T + 4) * 4 \
    + 4 * T * 4 + 1024


def ssd_intra_plain(cc: torch.Tensor, bc: torch.Tensor, acum: torch.Tensor,
                    xd: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's body as plain torch ops, batched over (BC, H):
    scores ``cc @ bc^T``, the lower-triangular decay ``exp(acum_i -
    acum_j)``, then ``(scores * decay) @ xd``, fp32 inside."""
    q = cc.shape[1]
    scores = cc.float() @ bc.float().transpose(-1, -2)      # (BC, Q, Q)
    diff = acum.float()[..., :, None] - acum.float()[..., None, :]
    lower = torch.ones((q, q), dtype=torch.bool, device=cc.device).tril()
    ell = torch.where(lower, torch.exp(diff), 0.0)          # (BC, H, Q, Q)
    return ((scores[:, None] * ell) @ xd.float()).to(xd.dtype)


def launch_plan(bcn: int, h: int, q: int, n: int, p: int) -> dict:
    """A copy of ``_plan``'s plan for these shapes."""
    return dict(_plan(bcn, h, q, n, p))


@functools.lru_cache(maxsize=256)
def _plan(bcn: int, h: int, q: int, n: int, p: int) -> dict:
    """How the kernel cuts one launch: ``heads`` a block (2 or 4: one or
    two a warpgroup), in ``groups`` of heads, ``tiles`` row tiles of T rows
    a chunk, the ``grid`` (groups, BC, tiles) and its ``blocks``,
    ``threads`` and ``smem`` bytes a block.  N (<= MAX_N) and P (<= MAX_P)
    fit one tile each and do not change the cut.

    A block of row tile r walks r + 1 column tiles, each a stage for the
    scores (shared by its heads) and one per two heads, so its ``stages``
    are (r + 1)(1 + heads / 2).  The heads a block are the ones that
    minimise the larger of the stages per SM, Σ stages / SMS, and the
    longest block's (``longest``): fewer heads fill the SMs at small BC,
    more form the scores fewer times; a tie takes more heads."""
    tiles = -(-q // T)
    rows = tiles * (tiles + 1) // 2          # Σ (r + 1) over the row tiles

    def cost(hb):
        groups = -(-h // hb)
        total = bcn * rows * groups * (1 + hb // 2)
        longest = tiles * (1 + hb // 2)
        return max(total / SMS, longest), total, longest

    hb = min(HEADS, key=lambda k: (cost(k)[0], -k))
    groups = -(-h // hb)
    _, total, longest = cost(hb)
    return {"heads": hb, "groups": groups, "tiles": tiles,
            "grid": (groups, bcn, tiles), "blocks": groups * bcn * tiles,
            "threads": THREADS, "smem": SMEM, "stages": total,
            "longest": longest}


def _launch_fn():
    return _build.entry("ssd_chunk_sm90", "ssd_intra_launch",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                        + [ctypes.c_void_p])


def ssd_intra(cc: torch.Tensor, bc: torch.Tensor, acum: torch.Tensor,
              xd: torch.Tensor) -> torch.Tensor:
    """cc, bc: (BC, Q, N); acum: (BC, H, Q); xd: (BC, H, Q, P), all fp32
    and contiguous on the card, N <= MAX_N and P <= MAX_P.  Returns y_diag
    (BC, H, Q, P)."""
    if cc.device.type == "cpu":
        return ssd_intra_plain(cc, bc, acum, xd)
    if cc.device.type != "cuda":
        raise ValueError(f"no SSD kernel for device {cc.device}")
    if cc.dim() != 3 or xd.dim() != 4:
        raise ValueError(f"expected cc, bc (BC, Q, N) and xd (BC, H, Q, P); "
                         f"got {tuple(cc.shape)}, {tuple(xd.shape)}")
    bcn, q, n = cc.shape
    _, h, _, p = xd.shape
    for name, t, shape in (("cc", cc, (bcn, q, n)), ("bc", bc, (bcn, q, n)),
                           ("acum", acum, (bcn, h, q)),
                           ("xd", xd, (bcn, h, q, p))):
        if t.device != cc.device:
            raise ValueError(f"{name} is on {t.device}, cc on {cc.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if p > MAX_P:
        raise ValueError(f"head dim P={p} above the kernel's {MAX_P}")
    if n > MAX_N:
        raise ValueError(f"state dim N={n} above the kernel's {MAX_N}")
    out = torch.empty_like(xd)
    if out.numel() == 0:
        return out
    plan = _plan(bcn, h, q, n, p)
    if bcn > 65535 or plan["tiles"] > 65535:
        raise ValueError(f"BC={bcn}, Q={q}: grid above the card's 65,535")
    vec = int(n % 4 == 0 and cc.data_ptr() % 16 == 0
              and bc.data_ptr() % 16 == 0)
    with torch.cuda.device(cc.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launch_fn()(cc.data_ptr(), bc.data_ptr(), acum.data_ptr(),
                           xd.data_ptr(), out.data_ptr(), bcn, h, q, n, p,
                           plan["heads"], vec, stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra launch failed: cudaError_t {err}")
    ssd_intra.launches += 1
    return out


ssd_intra.launches = 0
