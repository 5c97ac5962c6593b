"""sl(3) -> SL(3) via a control-flow-free Pade matrix exponential.

Torch twin of marf_tpu/ops/lie.py. An 8-vector h parametrizes the traceless
generator (reference warp.py:98-106)

    A = [[h5,     h3,  h1],
         [h4, -h5-h6,  h2],
         [h7,     h8,  h6]]     (1-indexed as in the reference)

and H = expm(A). `expm_pade_static` replicates the float32 path of
jax.scipy.linalg.expm (scaling-and-squaring, Pade 3/5/7) computation for
computation, with every data-dependent branch replaced by compute-all +
select: all three Pade pairs are formed and chosen with `torch.where`, and the
16 possible squarings are unrolled behind masks. The squaring count is never
read on the host, so a step has no device->host sync here, and the final-PSNR
sensitivity to the expm's f32 rounding (about 3 dB between expm
implementations) stays with the same Pade numerics. The VJP comes from
autograd; the squaring count and Pade order are piecewise-constant, so they
are computed from a detached input.
"""

from __future__ import annotations

import torch

_F32_MAXNORM = 3.925724783138660
_F32_CONDS = (4.258730016922831e-01, 1.880152677804762e00)
_MAX_SQUARINGS = 16


def sl3_generator(h: torch.Tensor) -> torch.Tensor:
    """[..., 8] Lie-algebra coordinates -> [..., 3, 3] traceless generator."""
    h1, h2, h3, h4, h5, h6, h7, h8 = h.unbind(-1)
    row0 = torch.stack([h5, h3, h1], dim=-1)
    row1 = torch.stack([h4, -h5 - h6, h2], dim=-1)
    row2 = torch.stack([h7, h8, h6], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def _pade3(A, ident):
    b = (120.0, 60.0, 12.0, 1.0)
    A2 = A @ A
    U = A @ (b[3] * A2 + b[1] * ident)
    V = b[2] * A2 + b[0] * ident
    return U, V


def _pade5(A, ident):
    b = (30240.0, 15120.0, 3360.0, 420.0, 30.0, 1.0)
    A2 = A @ A
    A4 = A2 @ A2
    U = A @ (b[5] * A4 + b[3] * A2 + b[1] * ident)
    V = b[4] * A4 + b[2] * A2 + b[0] * ident
    return U, V


def _pade7(A, ident):
    b = (17297280.0, 8648640.0, 1995840.0, 277200.0, 25200.0, 1512.0, 56.0, 1.0)
    A2 = A @ A
    A4 = A2 @ A2
    A6 = A4 @ A2
    U = A @ (b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * ident)
    V = b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * ident
    return U, V


def expm_pade_static(A: torch.Tensor) -> torch.Tensor:
    """Batched float32 Pade expm of [..., n, n] with no data-dependent
    control flow; NaN where the squaring count would exceed 16 (the
    reference implementation's guard)."""
    ident = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
    with torch.no_grad():
        A_L1 = A.abs().sum(dim=-2).amax(dim=-1)  # [...] 1-norm
        n_sq = torch.clamp(torch.floor(torch.log2(A_L1 / _F32_MAXNORM)), min=0.0)
        # digitize(A_L1, conds): the number of thresholds at or below A_L1
        idx = ((A_L1 >= _F32_CONDS[0]).to(torch.int32) + (A_L1 >= _F32_CONDS[1]).to(torch.int32))
        idx = idx[..., None, None]
        scale = torch.pow(2.0, n_sq)[..., None, None]
    As = A / scale
    U3, V3 = _pade3(As, ident)
    U5, V5 = _pade5(As, ident)
    U7, V7 = _pade7(As, ident)
    U = torch.where(idx == 0, U3, torch.where(idx == 1, U5, U7))
    V = torch.where(idx == 0, V3, torch.where(idx == 1, V5, V7))
    # solve(Q, P); solve_ex skips the singularity check that would sync with the host
    R = torch.linalg.solve_ex(-U + V, U + V, check_errors=False)[0]
    for i in range(_MAX_SQUARINGS):
        R = torch.where((i < n_sq)[..., None, None], R @ R, R)
    return torch.where((n_sq > _MAX_SQUARINGS)[..., None, None], torch.full_like(R, float("nan")), R)


def sl3_to_SL3(h: torch.Tensor) -> torch.Tensor:
    """[..., 8] sl(3) coordinates -> [..., 3, 3] homographies (det = 1)."""
    if h.dtype != torch.float32:
        raise NotImplementedError("sl3_to_SL3 implements the float32 Pade constants only")
    return expm_pade_static(sl3_generator(h))
