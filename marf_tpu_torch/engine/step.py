"""The train step and its chunks (twin of marf_tpu/engine/step.py).

`make_train_step` decides the gradient path once (`_decide_path`) and builds
it with its builder (`_BUILDERS`), which stages that path's constants; the
fused paths compute the autograd path's update:
  - `_autograd_grads`: `graph_forward` + `graph_loss` + backward; on a mesh,
    `_partitioned_grads` (marf_tpu's GSPMD step) on a rank's block;
  - `_fixed_grads`, fixed masks: one call of the rgb kernel (`_rgb_leg`,
    ops/cuda/fused_step.py) returns the MLP gradients and dH (K1, warp in the
    kernel) or dcoords (K2: fused_warp=off, more than 8 images), which
    autograd pulls back to the warp through the expm or the warp only;
  - `_dedup_grads`, the shared mask head on dedup columns (marf_tpu
    `_fused_implicit_dedup_grads`): K3 (mask forward) -> the rgb kernel
    masked by the predicted m -> the gradient-blocked edge term -> K4 (mask
    backward, ops/cuda/fused_mask.py), with the cotangent
    dL/dm = (a sq + b esq + c) m + k from `mask_cot_scalars`;
  - `_heads_grads`, per-image heads or the shared head at fused_dedup=off
    (marf_tpu `_fused_implicit_grads`): K5 (mask forward + the rgb step with
    the unnormalized cotangent, ops/cuda/fused_implicit.py) -> the
    1 / (3 sum m) scaling -> the edge term -> K6 (head-blocked mask backward).
K1-K6 run at `arch.compute_dtype` (float32 or bfloat16). Then the optimizer
(optim.algo, per-group learning rates; reference model/planar.py:86-104),
Homography_Error from the post-update warp, Mask_Error of the pre-update
mask, and the fix_first re-zero of warp 0 (reference model/planar.py:156-158).

A step's constants and per-step tables (`_Tables`) are built when it is
made; it reads its row at a device step counter and moves its learning rates
on the device (`LrSchedule`), so `make_train_chunk` can capture it as CUDA
graphs (marf_tpu's `lax.scan`).
"""

from __future__ import annotations

import functools
import gc
import math

import numpy as np
import torch
import torch.distributed

from marf_tpu_torch.models.implicit_mask import mask_head_inputs_cf
from marf_tpu_torch.models.planar import (
    Graph,
    PlanarConfig,
    graph_forward,
    graph_loss,
    map_outputs,
    use_fused_dedup,
    use_fused_implicit,
    use_fused_step,
    use_lazy_metrics,
)
from marf_tpu_torch.ops.filters import compute_edges
from marf_tpu_torch.ops.lie import sl3_to_SL3
from marf_tpu_torch.ops.losses import (
    alpha_schedule,
    check_finite,
    homography_error,
    mse,
    psnr_from_rgb_loss,
    render_loss,
    summarize_loss,
)
from marf_tpu_torch.ops.posenc import barf_c2f_weights
from marf_tpu_torch.ops.warp import warp_grid_cf_flat
from marf_tpu_torch.utils import trace
from marf_tpu_torch.utils.console import log


def _lr_lambda(optim_opt: dict, base_lr: float, max_iter: int):
    """Per-step LR factor from the reference's `optim.sched`, or None.

    The reference builds a scheduler but never steps it, so a configured
    schedule stays inert unless `optim.apply_sched` is set (fix mode):
    StepLR: gamma^(step // steps); ExponentialLR: gamma^step, gamma derived
    from optim.lr_end over max_iter when not given."""
    sched = optim_opt.get("sched") or {}
    stype = sched.get("type")
    if not stype or not optim_opt.get("apply_sched"):
        return None
    if stype == "StepLR":
        steps, gamma = int(sched["steps"]), float(sched.get("gamma", 0.1))
        return lambda count: gamma ** (count // steps)
    if stype == "ExponentialLR":
        if sched.get("gamma") is not None:
            gamma = float(sched["gamma"])
        else:
            gamma = (float(optim_opt["lr_end"]) / base_lr) ** (1.0 / max_iter)
        return lambda count: gamma**count
    raise ValueError(f"unsupported scheduler type: {stype}")


class OptaxRMSprop(torch.optim.Optimizer):
    """RMSprop with optax.rmsprop's update: nu = decay nu + (1 - decay) g^2,
    p -= lr g / sqrt(nu + eps), eps inside the root. torch.optim.RMSprop
    divides by sqrt(nu) + eps, which at this model's gradient sizes moves the
    first steps by up to an order of magnitude. The learning rate may be a
    0-d tensor on the device (`LrSchedule`): the update is tensor ops, and
    reads no value back to the host."""

    def __init__(self, params, lr: float, decay: float = 0.99, eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad, value=1.0 - group["decay"])
                p.sub_(p.grad / (nu + group["eps"]).sqrt() * group["lr"])


def _algo(name: str, groups: list, device: torch.device) -> torch.optim.Optimizer:
    """The reference's `optim.algo` (torch optimizer names,
    options/planar.yaml:78) with marf_tpu's hyperparameters (engine/step.py
    `_algo`): torch's defaults, optax's RMSprop update. On a card every
    optimizer steps without reading a value back to the host, so that a
    CUDA graph can capture it: Adam and AdamW are built `capturable`, SGD
    `fused` (both take a learning rate that is a tensor on the card); on
    the CPU they are built as torch builds them."""
    card = device.type == "cuda"
    if name == "Adam":
        return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8, capturable=card)
    if name == "AdamW":
        return torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01, capturable=card)
    if name == "SGD":
        return torch.optim.SGD(groups, lr=groups[0]["lr"], fused=card or None)
    if name == "RMSprop":
        return OptaxRMSprop(groups, lr=groups[0]["lr"], decay=0.99, eps=1e-8)
    raise ValueError(f"unsupported optimizer: {name}")


class LrSchedule:
    """`optim.sched` applied on the device, LambdaLR's twin: position s (a
    0-d int64 tensor on the parameters' device) gives group g the rate
    base_lr[g] x factor_g(s), read from a table of every step's rates
    [groups, max_iter + 1] built once (past max_iter, the last one's). The
    groups' learning rates are 0-d tensors that `step()` overwrites in
    place, so a step captured in a CUDA graph moves its rates with no host
    value. The table is float64 on the CPU, as LambdaLR's Python floats
    are, and float32 on a card, where capturable Adam takes it. The state
    dict is LambdaLR's `last_epoch` and `base_lrs`, so a LambdaLR state
    loads."""

    def __init__(self, optimizer: torch.optim.Optimizer, lambdas: list, max_iter: int):
        self.optimizer = optimizer
        self.max_iter = int(max_iter)
        self.lambdas = [fn or (lambda _: 1.0) for fn in lambdas]
        device = optimizer.param_groups[0]["params"][0].device
        dtype = torch.float32 if device.type == "cuda" else torch.float64
        self.position = torch.zeros((), dtype=torch.int64, device=device)
        self.lrs = torch.zeros(len(self.lambdas), dtype=dtype, device=device)  # group g's rate is lrs[g]
        for group in optimizer.param_groups:
            group.setdefault("initial_lr", group["lr"])  # as LambdaLR records it
        self._set_base_lrs([float(g["lr"]) for g in optimizer.param_groups])
        self._write()

    def _set_base_lrs(self, base_lrs: list) -> None:
        """The table of every step's rates: base_lr x factor(s), computed as
        LambdaLR computes each rate."""
        self.base_lrs = [float(b) for b in base_lrs]
        rates = [[base * fn(s) for s in range(self.max_iter + 1)] for base, fn in zip(self.base_lrs, self.lambdas)]
        self.table = torch.tensor(rates, dtype=torch.float64).to(self.lrs.device, self.lrs.dtype)

    def _write(self) -> None:
        """The rates at the position into the groups' learning rates."""
        for i, group in enumerate(self.optimizer.param_groups):
            group["lr"] = self.lrs[i]
        self.lrs.copy_(self.table.index_select(1, self.position.view(1))[:, 0])

    def step(self) -> None:
        """Advance one step, after the optimizer's (LambdaLR.step())."""
        self.position.add_(1).clamp_(max=self.max_iter)
        self.lrs.copy_(self.table.index_select(1, self.position.view(1))[:, 0])

    def state_dict(self) -> dict:
        return {"last_epoch": int(self.position), "base_lrs": list(self.base_lrs)}

    def load_state_dict(self, state: dict) -> None:
        """A state of this class or of LambdaLR; its base rates win, as in
        LambdaLR."""
        if [float(b) for b in state["base_lrs"]] != self.base_lrs:
            self._set_base_lrs(state["base_lrs"])
        self.position.fill_(min(int(state["last_epoch"]), self.max_iter))
        self._write()


def make_optimizer(graph: Graph, optim_opt: dict, max_iter: int):
    """`optim.algo` (Adam, AdamW, SGD or RMSprop) with one learning rate per
    group: the neural image at optim.lr, the warp at optim.lr_warp, the mask
    head at optim.lr_mask (a missing key gives optim.lr; a 0 stays 0). The
    view embedding takes a fourth group, at a constant optim.lr_mask that no
    schedule moves (the JAX package's "frozen" group), only when it takes
    gradients (optim.train_view_embedding); the reference never optimizes
    it. Returns (optimizer, `LrSchedule` or None); step the schedule once
    per step."""
    lr = float(optim_opt["lr"])
    groups = [
        {"params": list(graph.neural_image.parameters()), "lr": lr},
        {"params": [graph.warp], "lr": float(optim_opt.get("lr_warp", lr))},
    ]
    lambdas = [_lr_lambda(optim_opt, g["lr"], max_iter) for g in groups]
    if hasattr(graph, "implicit_mask"):
        lr_mask = float(optim_opt.get("lr_mask", lr))
        groups.append({"params": list(graph.implicit_mask.parameters()), "lr": lr_mask})
        lambdas.append(_lr_lambda(optim_opt, lr_mask, max_iter))
        if graph.view_embedding.requires_grad:
            groups.append({"params": [graph.view_embedding], "lr": lr_mask})
            lambdas.append(None)
    opt = _algo(optim_opt.get("algo", "Adam"), groups, graph.warp.device)
    if (optim_opt.get("sched") or {}).get("type") and not optim_opt.get("apply_sched"):
        log.warn(
            "optim.sched is configured but inert (reference-faithful: the reference never steps its "
            "scheduler); set optim.apply_sched=true to apply it for real"
        )
    if all(fn is None for fn in lambdas):
        return opt, None
    return opt, LrSchedule(opt, lambdas, max_iter)


def implicit_loss_coeffs(cfg: PlanarConfig, alpha):
    """Loss-term coefficients of the implicit-mask pipeline: total =
    sum_k 10^w_k loss_k with render = (1 - alpha) rgb + 0.5 mask + alpha edge
    (reference model/planar.py:371-374). Returns (C_r, C_e, C_m)."""
    w_render = 10.0 ** float(cfg.w_render)
    C_r = w_render * (1.0 - alpha)
    if cfg.w_rgb is not None:
        C_r = C_r + 10.0 ** float(cfg.w_rgb)
    C_e = w_render * alpha
    if cfg.w_edge is not None:
        C_e = C_e + 10.0 ** float(cfg.w_edge)
    C_m = w_render * 0.5
    if cfg.w_mask is not None:
        C_m = C_m + 10.0 ** float(cfg.w_mask)
    return C_r, C_e, C_m


def mask_cot_scalars(C_r, C_e, C_m, inv_sum3, rgb_loss, edge_loss, N, use_edges):
    """(a, b, c, k) of the mask cotangent dL/dm = (a sq + b esq + c) m + k,
    from dL/dm_i = C_r (2 m_i sq_i - 3 rgb_l) / (3 sum m)
                 + C_e (2 m_i esq_i - 3 edge_l) / (3 sum m) + C_m 2 (m_i - 1) / N.
    a, b, k are 0-d tensors on the device; c is a float."""
    a_s = 2.0 * C_r * inv_sum3
    b_s = 2.0 * C_e * inv_sum3 if use_edges else torch.zeros_like(a_s)
    c_s = 2.0 * C_m / N
    k_s = -3.0 * inv_sum3 * (C_r * rgb_loss + C_e * edge_loss) - 2.0 * C_m / N
    return a_s, b_s, c_s, k_s


# The dedup columns are padded to a multiple of this: X [56, K] is read in
# place by K3's and K4's layer-0 products, and the tensor-core engine copies
# an operand 16 bytes at a time only when its row stride is a multiple of 4
# floats (4 bytes at a time otherwise). A pixel-sharded step pads to a
# multiple of this times the ranks, so that each rank's block keeps it.
DEDUP_COLUMN_MULTIPLE = 4


def stage_mask_inputs(graph: Graph, images: torch.Tensor, n_ranks: int = 1, rank: int = 0) -> tuple:
    """The fused dedup step's constant inputs for rank `rank` of `n_ranks`,
    built once on the host (factoring and slot0+extras dedup,
    ops/cuda/fused_mask.py `slot_dedup_sharded_inputs`) and moved to the
    graph's device: (X_all [56, K_pad], cnt_all [1, K_pad], slot0 [1, Nl] of
    the rank's Nl = N / n_ranks positions, the rank's extra (position,
    column) pairs as three int64 [P] streams (position within its block,
    image, extra column - HW), table [8, 384], K). The K = HW + E dedup
    columns are padded with inert zero columns (X = 0, cnt = 0) to K_pad, a
    multiple of DEDUP_COLUMN_MULTIPLE n_ranks."""
    from marf_tpu_torch.ops.cuda.fused_mask import factor_mask_inputs, slot_dedup_sharded_inputs

    with torch.no_grad():
        uv, onehot, table = factor_mask_inputs(graph.view_embedding.cpu(), images.cpu(), graph.grid.cpu())
    X_all, slot0, cnt_all, ext_off, ext_col, ext_val = slot_dedup_sharded_inputs(
        uv.numpy(), onehot.numpy(), n_ranks, DEDUP_COLUMN_MULTIPLE)
    HW = uv.shape[1]
    Nl = slot0.shape[1] // n_ranks
    E = int(ext_col.max()) + 1 - HW if ext_val.any() else 0
    real = ext_val[rank] > 0
    off = ext_off[rank][real].astype(np.int64)
    pairs = (off, (rank * Nl + off) // HW, ext_col[rank][real].astype(np.int64) - HW)
    dev = graph.warp.device
    arrays = (X_all, cnt_all, slot0[:, rank * Nl : (rank + 1) * Nl], *pairs)
    return (*(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays), table.to(dev), HW + E)


def stage_mask_x(graph: Graph, images: torch.Tensor, single: bool) -> tuple:
    """K5's and K6's constant input, built once on the graph's device:
    (X [56, N], table [8, 384]). Head h owns the columns h HW .. (h+1) HW - 1:
    per-image X [B, 56, HW] is flattened in that order (marf_tpu
    engine/step.py:480-481)."""
    from marf_tpu_torch.ops.cuda.fused_mask import build_mask_x, factor_mask_inputs

    with torch.no_grad():
        uv, onehot, table = factor_mask_inputs(graph.view_embedding, images, graph.grid)
        X = build_mask_x(uv, onehot, single)
        if single:
            X = X.transpose(0, 1).reshape(X.shape[1], -1)
    return X.contiguous(), table


def set_grads(layers, grads) -> None:
    """Give each nn.Linear of `layers` its (dW, db)."""
    for layer, (dw, db) in zip(layers, grads):
        layer.weight.grad = dw
        layer.bias.grad = db


def _flat(pairs) -> list:
    return [t for pair in pairs for t in pair]


def _pairs(ts) -> list:
    return list(zip(ts[0::2], ts[1::2]))


def head_spans(cols: slice, span: int) -> list:
    """(head, first column, end column) of each head whose positions [h span,
    (h+1) span) of the flat axis meet a rank's block `cols`, in the block's
    columns."""
    return [(h, max(cols.start, h * span) - cols.start, min(cols.stop, (h + 1) * span) - cols.start)
            for h in range(cols.start // span, -(-cols.stop // span))]


def _decide_path(cfg: PlanarConfig, device: torch.device, n_ranks: int | None) -> tuple[str, str, bool]:
    """`make_train_step`'s path on `device` and n_ranks ranks (None: no mesh):
    (its kind, a key of `_BUILDERS`; the rgb leg; whether the ranks shard the
    flat pixel axis: it divides over them, for per-image heads B >= n_ranks)."""
    from marf_tpu_torch.ops.cuda.fused_step import MAX_IMAGES

    h, w = cfg.map_hw
    sharded = n_ranks is not None and (cfg.batch_size * h * w) % n_ranks == 0
    rgb_leg = "K2" if cfg.fused_warp == "off" or cfg.batch_size > MAX_IMAGES else "K1"
    if use_fused_implicit(cfg, device):
        if cfg.build_single_masks:
            sharded = n_ranks is not None and cfg.batch_size >= n_ranks
        return ("dedup" if use_fused_dedup(cfg, device) else "heads"), rgb_leg, sharded
    if use_fused_step(cfg, device):
        return "fixed", rgb_leg, sharded
    return ("partitioned" if sharded else "autograd"), rgb_leg, sharded


def _path_name(cfg: PlanarConfig, kind: str, rgb_leg: str, sharded: bool) -> str:
    if kind == "dedup":
        return f"fused implicit dedup (K3 -> {rgb_leg} -> {'K6 with column counts' if sharded else 'K4'})"
    if kind == "heads":
        return f"fused implicit, {'per-image heads' if cfg.build_single_masks else 'shared head, no dedup'} (K5 -> K6)"
    return f"fused ({rgb_leg})" if kind == "fixed" else "autograd"


def step_path(cfg: PlanarConfig, device: torch.device, n_ranks: int | None = None) -> tuple[str, bool]:
    """`make_train_step`'s path (`_decide_path`), named as its log line names
    it, and whether n_ranks ranks (None: no mesh) shard the flat pixel axis."""
    kind, rgb_leg, sharded = _decide_path(cfg, device, n_ranks)
    return _path_name(cfg, kind, rgb_leg, sharded), sharded


class _Layout:
    """Where a step runs: the block `cols` of the flat pixel axis N = B*HW
    (column order b*HW + i; per-image heads: images [r B / D, (r+1) B / D))
    on rank r of D (0 of 1 unsharded); `reduce` sums {name: [tensors]} over
    the ranks (one packed all_reduce), `place` puts a block in the whole axis
    for a sum that gathers, a mean over positions is `pos_part` per rank and
    `pos_mean` of the sum; the premade masks [1, N] and at this rank's
    positions (or None); the log line's `where`, and `why` it is replicated."""

    def __init__(self, cfg: PlanarConfig, device: torch.device, kind: str, sharded: bool, mesh, data: dict):
        h, w = cfg.map_hw
        B, HW, N = cfg.batch_size, h * w, cfg.batch_size * h * w
        D, r = (mesh.world_size, mesh.rank) if sharded else (1, 0)
        by_image = kind == "heads" and cfg.build_single_masks  # whole images per rank
        cols = slice(r * B // D * HW, (r + 1) * B // D * HW) if by_image else slice(r * (N // D), (r + 1) * (N // D))
        self.h, self.w, self.B, self.HW, self.N = h, w, B, HW, N
        self.sharded, self.D, self.r, self.cols, self.Nl = sharded, D, r, cols, cols.stop - cols.start
        self.collectives, self.reduce, self.place = None, (lambda parts: parts), (lambda t, n, start: t)
        self.pos_part, self.pos_mean = torch.mean, (lambda s: s)
        if sharded:
            from marf_tpu_torch.parallel.mesh import Collectives, place_columns

            self.collectives = Collectives()
            self.reduce, self.place = self.collectives.psum, place_columns
            self.pos_part, self.pos_mean = torch.sum, (lambda s: s / N)
        self.masks_full = self.masks_ref = None
        if cfg.use_implicit_mask and cfg.use_masks and data.get("masks") is not None:
            self.masks_full = data["masks"].permute(1, 0, 2, 3).reshape(1, N)
            self.masks_ref = self.masks_full[:, cols]
        self.where, self.why = f"on {device}", None
        if mesh is not None:
            ranks = f"{mesh.world_size} ranks ({mesh.backend}), rank {mesh.rank} on {device}"
            self.where = (f"sharded over {ranks}, {self.Nl} of {N} positions" if sharded else
                          f"replicated on {ranks}, all {N} positions")
            if not sharded:
                self.why = (f"fewer images (B = {B}) than ranks for per-image heads" if by_image else
                            f"the flat pixel axis (N = {B} x {h} x {w} = {N}) does not divide over {mesh.world_size} ranks")

    def cf(self, t: torch.Tensor) -> torch.Tensor:
        """A data stream [B, C, h, w] at this rank's positions, [C, Nl]."""
        return t.permute(1, 0, 2, 3).reshape(t.shape[1], self.N)[:, self.cols].contiguous()


class _Tables:
    """The per-step tables [max_iter + 1, ...] read at the step counter (`at`):
    `steps`, `progress`, `alphas` and `cws` (c2f weights, made at the first
    read, by a fused path); `zero`; `lazy`: metric-only work when heavy."""

    def __init__(self, cfg: PlanarConfig, device: torch.device):
        self.arch, self.lazy = cfg.arch, use_lazy_metrics(cfg, device)
        self.steps = torch.arange(cfg.max_iter + 1, device=device)
        self.progress = self.steps.to(torch.float32) / cfg.max_iter
        self.zero = torch.zeros((), dtype=torch.float32, device=device)
        self.alphas = (alpha_schedule(self.steps, cfg.max_iter, cfg.alpha_initial, cfg.alpha_final) if cfg.use_edges
                       else self.zero.expand(len(self.steps)))

    @functools.cached_property
    def cws(self):
        a = self.arch
        return None if not a.posenc_L or a.barf_c2f is None else barf_c2f_weights(self.progress, tuple(a.barf_c2f),
                                                                                    a.posenc_L)

    @staticmethod
    def at(table, idx):
        return table.index_select(0, idx)[0]  # idx [1] on the device: no index read back to the host


def _warp_coords(graph: Graph, cols: slice) -> torch.Tensor:
    """The warped grid at a rank's positions, [2, Nl], contiguous (as K2 and
    K5 take it), differentiable in the warp."""
    return warp_grid_cf_flat(graph.grid, graph.warp)[:, cols].contiguous()


def _rgb_leg(cfg: PlanarConfig, graph: Graph, data: dict, lay: _Layout, tab: _Tables, leg: str):
    """The rgb kernel K1 or K2 (`leg`), its inputs staged: grads(idx, masks,
    g_loss_scale, inv_sum3, partials, gather_rgb) runs it at this rank's
    positions, sums the warp (dH on K1) and MLP gradients, the rgb loss,
    `partials` and, with gather_rgb, the rgb over the ranks, sets those
    gradients; -> (rgb [3, N] gathered, else [3, Nl], rgb_loss, sq, sums)."""
    from marf_tpu_torch.ops.cuda import kernel

    run = kernel(leg)  # the wrapper called inside its profiler range marf.K<i> (ops/cuda `kernel`)
    cols, N, cdtype, cws = lay.cols, lay.N, cfg.arch.compute_dtype, tab.cws
    targets_cf = lay.cf(data["rgb"])
    if leg == "K1":  # the kernel's (u, v, b) stream: the unwarped grid repeated per image
        b = torch.arange(lay.B, dtype=torch.float32, device=graph.warp.device).repeat_interleave(lay.HW)
        grid_b = torch.cat([graph.grid.T.repeat(1, lay.B), b[None]])[:, cols].contiguous()

    def grads(idx, masks, g_loss_scale, inv_sum3, partials: dict, gather_rgb: bool):
        cw = None if cws is None else tab.at(cws, idx)
        if leg == "K2":
            coords = _warp_coords(graph, cols)
            rgb_cf, rgb_loss, dmlp, dcoords, sq = run(graph.neural_image, coords.detach(), cw, targets_cf, masks,
                                                      g_loss_scale, inv_sum3, cdtype)
            (dgeo,) = torch.autograd.grad(coords, graph.warp, dcoords)
            finish = lambda g: g  # noqa: E731
        else:
            H = sl3_to_SL3(graph.warp)
            rgb_cf, rgb_loss, dmlp, dgeo, sq = run(graph.neural_image, grid_b, H.detach(), cw, targets_cf, masks,
                                                   g_loss_scale, inv_sum3, cdtype)
            finish = lambda g: torch.autograd.grad(H, graph.warp, g)[0]  # noqa: E731
        sums = lay.reduce({"geo": [dgeo], "loss": [rgb_loss], "mlp": _flat(dmlp), **partials,
                           "rgb": [lay.place(rgb_cf, N, cols.start)] if gather_rgb else []})
        set_grads(graph.neural_image.layers, _pairs(sums["mlp"]))
        graph.warp.grad = finish(sums["geo"][0])
        return (sums["rgb"][0] if gather_rgb else rgb_cf), sums["loss"][0], sq, sums

    return grads


class _ImplicitTerms:
    """What the fused implicit paths share besides `implicit_loss_coeffs`
    and `mask_cot_scalars`. Their edge term is not metric-only (its esq
    feeds K4 or K6), so it runs every step."""

    def __init__(self, cfg: PlanarConfig, data: dict, lay: _Layout, tab: _Tables):
        self.lay, self.tab = lay, tab
        self.edges_cf = data["edges"].permute(1, 0, 2, 3).contiguous() if cfg.use_edges else None

    def edge_sq(self, rgb_cf):
        """The edge term's squared error at this rank's positions, [1, Nl],
        from the whole rgb [3, N] ([3, B, h, w]: images as channels)."""
        lay = self.lay
        edge_pred_cf = compute_edges(rgb_cf.reshape(3, lay.B, lay.h, lay.w))
        return torch.sum((edge_pred_cf - self.edges_cf) ** 2, dim=0).reshape(1, lay.N)[:, lay.cols]

    def mask_terms(self, m, heavy: bool) -> dict:
        """This rank's parts of the mask loss and Mask_Error of m [1, Nl]."""
        parts = {"mask": [self.lay.pos_part((1.0 - m) ** 2)]}
        if self.lay.masks_ref is not None and (heavy or not self.tab.lazy):
            parts["mask_error"] = [self.lay.pos_part((m - self.lay.masks_ref) ** 2)]
        return parts

    def loss(self, rgb_loss, edge_loss, sums: dict, alpha) -> tuple:
        """The loss terms and Mask_Error (or None)."""
        mask_loss = self.lay.pos_mean(sums["mask"][0])
        mask_error = self.lay.pos_mean(sums["mask_error"][0]) if "mask_error" in sums else None
        loss = {"render": render_loss(rgb_loss, edge_loss, mask_loss, alpha), "rgb": rgb_loss, "mask": mask_loss,
                "edge": edge_loss}
        return loss, mask_error


def _fixed_grads(cfg, graph, optimizer, data, lay: _Layout, tab: _Tables, rgb_leg: str):
    """The fixed-mask path: the masks' normalizer is summed over the ranks
    once, here, outside any capture; the edge term is metric-only."""
    rgb_grads = _rgb_leg(cfg, graph, data, lay, tab, rgb_leg)
    masks = data.get("masks") if cfg.use_masks else None
    masks_cf = torch.ones((1, lay.Nl), dtype=torch.float32, device=graph.warp.device) if masks is None else lay.cf(masks)
    inv_sum3 = 1.0 / (lay.reduce({"m": [torch.sum(masks_cf)]})["m"][0] * 3.0)
    me = data.get("masks_eroded")
    me_cf = None if me is None else me.permute(1, 0, 2, 3).contiguous()
    edges_cf = data["edges"].permute(1, 0, 2, 3).contiguous() if cfg.use_edges else None
    c_render = 10.0 ** float(cfg.w_render)
    c_rgb = 10.0 ** float(cfg.w_rgb) if cfg.w_rgb is not None else None
    zero = tab.zero

    def grads(idx, heavy: bool):
        alpha = tab.at(tab.alphas, idx)
        # d total / d loss_rgb: the render term's (1 - alpha) plus the direct rgb term
        g_loss_scale = c_render * (1.0 - alpha)
        if c_rgb is not None:
            g_loss_scale = g_loss_scale + c_rgb
        edges = cfg.use_edges and (heavy or not tab.lazy)
        rgb_cf, rgb_loss, _, _ = rgb_grads(idx, masks_cf, g_loss_scale, inv_sum3, {}, edges)
        # the gradient-blocked edge term; [3, B, h, w] keeps the image axis as channels
        edge_loss = mse(compute_edges(rgb_cf.reshape(3, lay.B, lay.h, lay.w)), edges_cf, me_cf) if edges else zero
        loss = {"render": render_loss(rgb_loss, edge_loss, zero, alpha), "rgb": rgb_loss, "mask": zero, "edge": edge_loss}
        return loss, None

    return grads


def _dedup_grads(cfg, graph, optimizer, data, lay: _Layout, tab: _Tables, rgb_leg: str):
    """The dedup path on `stage_mask_inputs`; sharded, its dedup columns go
    apart from the positions, and K6 with their counts takes K4's place."""
    from marf_tpu_torch.ops.cuda import kernel
    from marf_tpu_torch.ops.cuda.fused_mask import mask_w_stack, unfactor_mask_grads

    fused_mask_forward, fused_mask_backward_dedup, fused_mask_backward_g = kernel("K3"), kernel("K4"), kernel("K6")
    rgb_grads = _rgb_leg(cfg, graph, data, lay, tab, rgb_leg)
    terms = _ImplicitTerms(cfg, data, lay, tab)
    B, HW, N, Nl, reduce, cdtype, zero = lay.B, lay.HW, lay.N, lay.Nl, lay.reduce, cfg.arch.compute_dtype, tab.zero
    with trace.span("setup.dedup"):
        X_all, cnt_all, slot0, ext_off, ext_img, ext_j, table, K = stage_mask_inputs(graph, data["rgb"], lay.D, lay.r)
    E = K - HW  # known at setup: the extras' index ops run only when E > 0
    trace.count("dedup_columns", K)
    trace.count("dedup_extras", E)
    trace.count("dedup_pairs", ext_off.numel())
    K_pad = X_all.shape[1]
    Klp = K_pad // lay.D
    kcols = slice(lay.r * Klp, (lay.r + 1) * Klp)  # this rank's dedup columns
    X_loc, cnt_loc = X_all[:, kcols].contiguous(), cnt_all[:, kcols].contiguous()
    # slot0 column p = n mod HW is affine over a contiguous block of
    # positions: a window of Nl from `start` in T tiles of HW
    start = (lay.r * Nl) % HW
    T = -(-(start + Nl) // HW)
    log.info(f"mask-head dedup: K = {K} columns (HW = {HW}, E = {E}; padded to {K_pad}) for N = {N} positions; "
             + (f"{Klp} columns and " if lay.sharded else "")
             + f"{ext_off.numel()} extra (position, column) pairs" + (" on this rank" if lay.sharded else ""))

    def extras_sum(v):
        """Per extra column, the sum of a position stream [1, Nl] over the
        rank's positions it covers, [E]: the pairs written into an image x
        column grid summed over images in a fixed order (no scatter-add)."""
        grid = v.new_zeros((B, E))
        grid[ext_img, ext_j] = v[0, ext_off]
        return torch.sum(grid, dim=0)

    def column_sums(v):
        """This rank's part of the per-dedup-column sums of a position stream
        [1, Nl], [1, K_pad]: slot0's by one write into the T tiles reduced
        over them, then the extras'."""
        tiles = v.new_zeros((1, T * HW))
        tiles[:, start : start + Nl] = slot0 * v
        out = v.new_zeros((1, K_pad))
        out[:, :HW] = tiles.reshape(T, HW).sum(0)
        if E:
            out[:, HW:K] = extras_sum(v)
        return out

    def grads(idx, heavy: bool):
        alpha = tab.at(tab.alphas, idx)
        C = implicit_loss_coeffs(cfg, alpha)
        # ---- mask forward on this rank's dedup columns, gathered to all K
        # and expanded to its positions: m[n] = slot0[n] m[n mod HW] + the
        # one extra column that covers n
        stack = mask_w_stack(graph.implicit_mask, table)
        m_loc = fused_mask_forward(stack, X_loc, cdtype)
        m_all = reduce({"m": [lay.place(m_loc, K_pad, kcols.start)]})["m"][0][:, :K]  # pad cut
        m_flat = slot0 * m_all[:, :HW].repeat(1, T)[:, start : start + Nl]
        if E:
            m_flat = m_flat.index_add(1, ext_off, m_all[:, HW + ext_j])
        inv_sum3 = 1.0 / (torch.dot(cnt_all[0, :K], m_all[0]) * 3.0)
        # ---- the rgb kernel, masked by the predicted m
        rgb_cf, rgb_loss, sq, sums = rgb_grads(idx, m_flat, C[0], inv_sum3, terms.mask_terms(m_flat, heavy),
                                               cfg.use_edges)
        esq = terms.edge_sq(rgb_cf) if cfg.use_edges else None
        if not lay.sharded:
            # ---- K4: the extras' segment sums go in `base`, slot0's in the
            # kernel; base and cnt are 0 on the pad columns, so is their cotangent
            edge_loss = torch.sum(m_flat * m_flat * esq) * inv_sum3 if cfg.use_edges else zero
            a_s, b_s, c_s, k_s = mask_cot_scalars(*C, inv_sum3, rgb_loss, edge_loss, N, cfg.use_edges)
            base = c_s * cnt_all
            if E:
                tail = a_s * extras_sum(sq)
                if esq is not None:
                    tail = tail + b_s * extras_sum(esq)
                base = base + torch.nn.functional.pad(tail[None], (HW, K_pad - K))
            dstack = fused_mask_backward_dedup(
                stack, X_all, slot0.reshape(B, HW), sq.reshape(B, HW), None if esq is None else esq.reshape(B, HW),
                base, cnt_all, torch.stack([a_s, b_s, k_s]), cdtype)
        else:
            # ---- K6 on this rank's dedup columns with their counts: the
            # global edge loss and segment sums of sq and esq first
            parts = {"sq": [column_sums(sq)]}
            if esq is not None:
                parts.update(edge=[torch.sum(m_flat * m_flat * esq)], esq=[column_sums(esq)])
            s = reduce(parts)
            edge_loss = s["edge"][0] * inv_sum3 if esq is not None else zero
            a_s, b_s, c_s, k_s = mask_cot_scalars(*C, inv_sum3, rgb_loss, edge_loss, N, cfg.use_edges)
            (dstack,) = fused_mask_backward_g([stack], X_loc, s["sq"][0][:, kcols],
                                              s["esq"][0][:, kcols] if esq is not None else None,
                                              torch.stack([a_s, b_s, k_s]), c_s, cnt_loc, cdtype)
            dstack = _pairs(reduce({"g": _flat(dstack)})["g"])
        set_grads(graph.implicit_mask.layers, unfactor_mask_grads(dstack, table))
        return terms.loss(rgb_loss, edge_loss, sums, alpha)

    return grads


def _heads_grads(cfg, graph, optimizer, data, lay: _Layout, tab: _Tables, rgb_leg: str):
    """The K5 -> K6 path on `stage_mask_x`; sharded, per-image heads go by
    whole images, the heads of other ranks entering the sum as zeros."""
    from marf_tpu_torch.ops.cuda import kernel
    from marf_tpu_torch.ops.cuda.fused_mask import mask_w_stack, unfactor_mask_grads

    fused_implicit_train_kernel, fused_mask_backward_g = kernel("K5"), kernel("K6")
    terms = _ImplicitTerms(cfg, data, lay, tab)
    N, cols, reduce, cdtype, cws = lay.N, lay.cols, lay.reduce, cfg.arch.compute_dtype, tab.cws
    targets_cf = lay.cf(data["rgb"])
    X_flat, table = stage_mask_x(graph, data["rgb"], cfg.build_single_masks)
    X_flat = X_flat[:, cols].contiguous()
    heads = list(graph.implicit_mask) if cfg.build_single_masks else [graph.implicit_mask]
    own = range(lay.r * lay.B // lay.D, (lay.r + 1) * lay.B // lay.D) if cfg.build_single_masks else range(1)

    def grads(idx, heavy: bool):
        alpha = tab.at(tab.alphas, idx)
        C = implicit_loss_coeffs(cfg, alpha)
        stacks = [mask_w_stack(heads[i], table) for i in own]
        # ---- K5: the mask forward on every head's column block, then the rgb
        # step masked by m with the unnormalized cotangent 2 C_r (rgb - t) m^2
        coords = _warp_coords(graph, cols)
        rgb_cf, m_flat, sq, dcoords_u, msum, loss_u, dmlp_u = fused_implicit_train_kernel(
            graph.neural_image, stacks, coords.detach(), X_flat, None if cws is None else tab.at(cws, idx), targets_cf,
            2.0 * C[0], cdtype,
        )
        (dwarp_u,) = torch.autograd.grad(coords, graph.warp, dcoords_u)
        sums = reduce({"msum": [msum], "loss": [loss_u], "warp": [dwarp_u], "mlp": _flat(dmlp_u),
                       **terms.mask_terms(m_flat, heavy),
                       "rgb": [lay.place(rgb_cf, N, cols.start)] if cfg.use_edges else []})
        # the masked-MSE normalization 1 / (3 sum m): K5's outputs are linear in it
        inv_sum3 = 1.0 / (sums["msum"][0] * 3.0)
        rgb_loss = sums["loss"][0] * inv_sum3
        graph.warp.grad = sums["warp"][0] * inv_sum3
        set_grads(graph.neural_image.layers, [(dw * inv_sum3, db * inv_sum3) for dw, db in _pairs(sums["mlp"])])
        # ---- the gradient-blocked edge term, per position [1, Nl]
        if cfg.use_edges:
            esq = terms.edge_sq(sums["rgb"][0])
            edge_loss = reduce({"e": [torch.sum(m_flat * m_flat * esq)]})["e"][0] * inv_sum3
        else:
            esq, edge_loss = None, tab.zero
        # ---- K6: each head's backward on its block with the per-column
        # cotangent; the heads of other ranks enter the sum as zeros
        a_s, b_s, c_s, k_s = mask_cot_scalars(*C, inv_sum3, rgb_loss, edge_loss, N, cfg.use_edges)
        dstacks = dict(zip(own, fused_mask_backward_g(stacks, X_flat, sq, esq, torch.stack([a_s, b_s, k_s]), c_s,
                                                      compute_dtype=cdtype)))
        like = _flat(dstacks[own[0]])
        summed = reduce({i: _flat(dstacks[i]) if i in dstacks else [torch.zeros_like(t) for t in like]
                         for i in range(len(heads))})
        for i, head in enumerate(heads):
            set_grads(head.layers, unfactor_mask_grads(_pairs(summed[i]), table))
        return terms.loss(rgb_loss, edge_loss, sums, alpha)

    return grads


def _partitioned_grads(cfg, graph, optimizer, data, lay: _Layout, tab: _Tables, rgb_leg: str):
    """Autograd on a rank's block: the networks at its positions, rgb and m
    gathered by one sum, one card's graph_loss on the whole maps on every
    rank (no halo), its cotangent back through the rank's networks, one sum
    of the gradients."""
    cols, N, HW = lay.cols, lay.N, lay.HW
    if cfg.use_implicit_mask:
        # the mask-head inputs at this rank's positions: its images' [426, HW]
        # blocks, cut to its columns; constants while the view embedding is frozen
        b0, b1 = cols.start // HW, -(-cols.stop // HW)

        def mask_inputs():
            x = mask_head_inputs_cf(graph.view_embedding, data["rgb"][b0:b1], graph.grid, cfg.mask_quantize_levels)
            return x.transpose(0, 1).reshape(x.shape[1], -1)[:, cols.start - b0 * HW : cols.stop - b0 * HW]

        if not cfg.train_view_embedding:
            with torch.no_grad():
                x_frozen = mask_inputs().contiguous()
            mask_inputs = lambda: x_frozen  # noqa: E731
        spans = head_spans(cols, HW)  # per-image heads: each image's columns on this rank

    def grads(idx, heavy: bool):
        optimizer.zero_grad(set_to_none=True)
        local = [graph.neural_image(_warp_coords(graph, cols), tab.at(tab.progress, idx))]
        if cfg.use_implicit_mask:
            x = mask_inputs()
            if cfg.build_single_masks:
                local.append(torch.cat([graph.implicit_mask[b](x[:, lo:hi]) for b, lo, hi in spans], dim=1))
            else:
                local.append(graph.implicit_mask(x))
        gathered = lay.reduce({"maps": [lay.place(t.detach(), N, cols.start) for t in local]})["maps"]
        maps = [t.detach().requires_grad_() for t in gathered]
        loss = graph_loss(map_outputs(cfg, *maps), data, cfg, tab.at(tab.steps, idx))
        cots = torch.autograd.grad(summarize_loss(loss, cfg.loss_weight), maps)
        torch.autograd.backward(local, [c[:, cols] for c in cots])
        params = [p for p in graph.parameters() if p.requires_grad]
        sums = lay.reduce({"g": [torch.zeros_like(p) if p.grad is None else p.grad for p in params]})["g"]
        for p, g in zip(params, sums):
            p.grad = g
        mask_error = None
        if lay.masks_full is not None and (heavy or not tab.lazy):
            mask_error = mse(maps[1].detach(), lay.masks_full)
        return {k: v.detach() for k, v in loss.items()}, mask_error

    return grads


def _autograd_grads(cfg, graph, optimizer, data, lay: _Layout, tab: _Tables, rgb_leg: str):
    """The autograd step; with a frozen view embedding the dense mask-head
    inputs are constants, staged here into the step's own `data`."""
    if cfg.use_implicit_mask and not cfg.train_view_embedding:
        with torch.no_grad():
            x = mask_head_inputs_cf(graph.view_embedding, data["rgb"], graph.grid, cfg.mask_quantize_levels)
        if not cfg.build_single_masks:
            x = x.transpose(0, 1).reshape(x.shape[1], -1)  # [426, B*HW]
        data = dict(data, mask_head_inputs_cf=x)

    def grads(idx, heavy: bool):
        optimizer.zero_grad(set_to_none=True)
        outputs = graph_forward(graph, data, cfg, tab.at(tab.progress, idx))
        loss = graph_loss(outputs, data, cfg, tab.at(tab.steps, idx))
        summarize_loss(loss, cfg.loss_weight).backward()
        mask_error = None
        if lay.masks_ref is not None and (heavy or not tab.lazy):
            m = outputs["mask_prediction_map"].detach()
            mask_error = mse(m.permute(1, 0, 2, 3).reshape(1, lay.N), lay.masks_ref)
        return {k: v.detach() for k, v in loss.items()}, mask_error

    return grads


# each path's builder: (cfg, graph, optimizer, data, layout, tables, rgb leg)
# -> grads(idx [1] on the device, heavy) -> (loss terms, Mask_Error or None)
_BUILDERS = {"autograd": _autograd_grads, "partitioned": _partitioned_grads, "fixed": _fixed_grads,
             "dedup": _dedup_grads, "heads": _heads_grads}


def make_train_step(cfg: PlanarConfig, graph: Graph, optimizer, data: dict, scheduler=None, use_homographies: bool = True,
                    mesh=None):
    """Build the step: a `TrainStep`, step(heavy=...) -> metrics dict of 0-d
    tensors, one step at its device counter: the path's gradients
    (`_decide_path`, `_BUILDERS`), then the tail that every path shares.

    Metric timing matches the reference's `log_scalars` call site
    (model/planar.py:199-201): loss terms and PSNR from the pre-update
    forward, Homography_Error from the post-update warp before the fix_first
    re-zero. `heavy` marks the chunk-final step: with lazy metrics, only it
    computes the metric-only work and the other rows report 0.

    With `mesh` (parallel/mesh.py) the step is one rank of a pixel-sharded
    step (marf_tpu/parallel/shard_fused.py, `_Layout`): what marf_tpu psums
    is summed over the ranks by one packed all_reduce at each point. Every
    rank passes the same `data` and `heavy`; parameters and optimizer state
    stay replicated. When N does not divide over the ranks (per-image heads:
    B < D), every rank runs its path's single-card step, with no sums."""
    device = graph.warp.device
    kind, rgb_leg, sharded = _decide_path(cfg, device, None if mesh is None else mesh.world_size)
    lay = _Layout(cfg, device, kind, sharded, mesh, data)
    if lay.why is not None:
        log.warn(f"{lay.why}; data stays replicated (single-card arithmetic on every rank)")
    name = _path_name(cfg, kind, rgb_leg, sharded)
    log.info(f"train step: {name}, {cfg.arch.compute_dtype}, {lay.where}")
    tab = _Tables(cfg, device)
    grads_fn = _BUILDERS[kind](cfg, graph, optimizer, data, lay, tab, rgb_leg)
    gt_hom = data.get("gt_hom") if use_homographies else None
    zero = tab.zero
    counter = torch.zeros((), dtype=torch.int64, device=device)  # the step, carried on the device

    def step_fn(heavy: bool) -> dict:
        idx = torch.clamp(counter, max=cfg.max_iter).view(1)  # the tables end at max_iter
        loss, mask_error = grads_fn(idx, heavy)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        metrics = {f"loss_{k}": v for k, v in loss.items()}
        metrics["all"] = summarize_loss(loss, cfg.loss_weight)
        metrics["PSNR"] = psnr_from_rgb_loss(loss["rgb"])
        metrics["finite"] = check_finite(loss)
        with torch.no_grad():
            if gt_hom is not None:
                metrics["Homography_Error"] = (homography_error(sl3_to_SL3(graph.warp), gt_hom)
                                               if (heavy or not tab.lazy) else zero)
            if lay.masks_ref is not None:
                metrics["Mask_Error"] = mask_error if (heavy or not tab.lazy) else zero
            if cfg.fix_first:
                graph.warp[0].zero_()
        counter.add_(1)
        return metrics

    return TrainStep(step_fn, counter, graph, optimizer, scheduler, mesh, lay.collectives, name, lay.where)


class TrainStep:
    """A train step from `make_train_step`: `step(heavy=...)` runs one step
    at the step counter, a 0-d int64 tensor on the device (marf_tpu's
    `TrainState.step`), advances it and returns the metrics, a dict of 0-d
    tensors; `heavy` marks the chunk-final step. `set_step(it)` writes the
    counter (after a restore) in place. `path` and `layout` are what its log
    line names. `collectives` (parallel/mesh.py) takes a sharded step's sums
    (None unsharded).

    Capture needs every tensor the step reads or writes across steps to
    keep its storage: parameters and optimizer state are updated in place,
    and `check_bound` raises once any of them was rebound (an optimizer's
    `load_state_dict` after capture needs a new step)."""

    def __init__(self, fn, counter: torch.Tensor, graph: Graph, optimizer, scheduler, mesh, collectives, path: str,
                 layout: str):
        self._fn, self.path, self.layout, self.counter, self.device = fn, path, layout, counter, counter.device
        self.graph, self.optimizer, self.scheduler = graph, optimizer, scheduler
        self.mesh, self.collectives = mesh, collectives
        self.chunk_state = None  # what its chunks share (`_ChunkState`), made by the first `make_train_chunk`

    def __call__(self, *, heavy: bool = True) -> dict:
        return self._fn(heavy)

    def set_step(self, it: int) -> None:
        self.counter.fill_(int(it))

    def bound_tensors(self) -> list:
        """The tensors a captured step reads and writes in place: parameters,
        optimizer state and rates, the schedule's position and table, counter."""
        out = [self.counter, *self.graph.parameters()]
        out += [t for st in self.optimizer.state.values() for t in st.values() if isinstance(t, torch.Tensor)]
        out += [g["lr"] for g in self.optimizer.param_groups if isinstance(g["lr"], torch.Tensor)]
        if self.scheduler is not None:
            out += [self.scheduler.position, self.scheduler.table]
        return out


def chunk_mode(step: TrainStep, capture: bool | None = None) -> tuple[bool, str]:
    """(capture, why) of a step's chunks. None (the default) captures on a
    card (a step under a mesh in `_Segments`); a chunk runs eager on the CPU
    and at capture=False; capture=True on the CPU raises."""
    if step.device.type != "cuda":
        if capture:
            raise ValueError(f"capture=True: CUDA graphs capture a step on a card, not on {step.device}")
        return False, step.device.type if step.mesh is None else step.mesh.backend
    if capture is False:
        return False, "capture=False"
    if step.mesh is not None:
        return True, f"{step.mesh.world_size} ranks, {step.mesh.backend}"
    return True, "CUDA graphs of a light and a heavy step, replayed"


class _Segments:
    """One step captured as CUDA graphs split at its collectives, the twin
    of marf_tpu's jit(shard_map(scan(step))): graph i runs from collective
    i - 1 to collective i, all in one memory pool on one stream (autograd's
    backward may use its forward's, in an earlier graph). `replay`
    all-reduces `buffers[i]`, collective i's packed buffer, in place between
    graph i and graph i + 1. `launches[i]` are the kernel launches graph i
    recorded; the capture itself counts none."""

    def __init__(self, pool):
        self.pool = pool
        self.graphs, self.buffers, self.launches = [], [], []
        self._before = None

    def begin(self) -> None:
        from marf_tpu_torch.ops.cuda import LAUNCHES

        self._before = dict(LAUNCHES)
        self.graphs.append(torch.cuda.CUDAGraph())
        self.graphs[-1].capture_begin(pool=self.pool)

    def end(self) -> None:
        from marf_tpu_torch.ops.cuda import LAUNCHES

        self.graphs[-1].capture_end()
        self.launches.append({k: v - self._before[k] for k, v in LAUNCHES.items() if v != self._before[k]})
        LAUNCHES.update(self._before)

    def cut(self, flat: torch.Tensor) -> None:
        """At a collective (`Collectives.psum` under capture): end this graph
        after the buffer's packing, keep the buffer, begin the next graph."""
        self.end()
        self.buffers.append(flat)
        self.begin()

    def replay(self, times: int) -> None:
        from marf_tpu_torch.ops.cuda import LAUNCHES

        for _ in range(times):
            for i, graph in enumerate(self.graphs):
                graph.replay()
                if i < len(self.buffers):
                    torch.distributed.all_reduce(self.buffers[i])
        for launches in self.launches:
            for k, v in launches.items():
                LAUNCHES[k] += v * times


class _ChunkState:
    """What a step's chunks share: the metric rows [capacity, k] on the
    device and their row counter, written by each step; after the first
    captured chunk, the light and the heavy step as `_Segments` and the
    storage of the tensors they were captured on. `issued[heavy]` holds each
    distinct list of collectives the steps of that kind issued: a captured
    step replays one list, so every step of a kind must issue the same."""

    def __init__(self, step: TrainStep):
        self.step, self.capacity, self.keys, self.rows, self.issued, self.bound = step, 0, None, None, {}, None
        self.row = torch.zeros((1,), dtype=torch.int64, device=step.device)
        self.segments = None  # {heavy: _Segments}
        self.mode = None  # the chunk mode last logged

    def reserve(self, n: int) -> None:
        if n > self.capacity and self.segments is not None:
            raise ValueError(f"a chunk of {n} steps: the captured step writes at most {self.capacity} rows")
        self.capacity = max(self.capacity, n)

    def step_and_record(self, heavy: bool) -> None:
        """One step; its metrics into the next row, its collectives into
        `issued`."""
        coll = self.step.collectives
        if coll is not None:
            coll.issued.clear()
        metrics = self.step(heavy=heavy)
        if self.rows is None or self.rows.shape[0] < self.capacity:
            self.keys = list(metrics)
            self.rows = torch.zeros((self.capacity, len(self.keys)), dtype=torch.float32, device=self.step.device)
        row = torch.stack([metrics[k].to(torch.float32) for k in self.keys])
        self.rows.index_copy_(0, self.row, row[None])
        self.row.add_(1)
        if coll is not None:
            self.issued.setdefault(heavy, set()).add(tuple(coll.issued))

    def check_issued(self) -> None:
        for heavy, lists in self.issued.items():
            if len(lists) > 1:
                raise RuntimeError(f"the {'heavy' if heavy else 'light'} steps issued {len(lists)} different lists "
                                   f"of collectives; a captured step replays one: {sorted(lists)}")

    def capture(self) -> None:
        """Capture the light and the heavy step (warmed up by the first
        chunk), each recording its metric row, as `_Segments` on one side
        stream into one memory pool. It runs no step and no collective and
        counts no launch; it raises where the steps' collectives differ."""
        device = self.step.device
        coll = self.step.collectives
        self.check_issued()
        torch.cuda.synchronize(device)  # as torch.cuda.graph prepares a capture
        gc.collect()
        torch.cuda.empty_cache()
        pool = torch.cuda.graph_pool_handle()
        main, side = torch.cuda.current_stream(device), torch.cuda.Stream(device)
        side.wait_stream(main)
        segments = {}
        with torch.cuda.stream(side):
            for heavy in (False, True):
                seg = segments[heavy] = _Segments(pool)
                seg.begin()
                if coll is not None:
                    coll.capture = seg
                try:
                    self.step_and_record(heavy)
                finally:
                    if coll is not None:
                        coll.capture = None
                    seg.end()
                trace.count("captures")
        main.wait_stream(side)
        self.check_issued()
        self.segments = segments
        self.bound = [t.data_ptr() for t in self.step.bound_tensors()]

    def check_bound(self) -> None:
        if [t.data_ptr() for t in self.step.bound_tensors()] != self.bound:
            raise RuntimeError("a tensor the captured step updates in place was rebound after capture (an "
                               "optimizer's load_state_dict?); make a new step")


class ChunkMetrics:
    """A dispatched chunk's metric rows, on their way to the host: a copy
    into pinned host memory behind an event on a card. `result()` waits for
    it: {name: [n] array}."""

    def __init__(self, keys: list, host: torch.Tensor, event):
        self.keys, self.host, self.event = keys, host, event

    def result(self) -> dict[str, np.ndarray]:
        with trace.span("chunk.wait"):
            if self.event is not None:
                self.event.synchronize()
            arr = self.host.numpy().copy()  # off the pinned buffer
        return {k: arr[:, j] for j, k in enumerate(self.keys)}


class TrainChunk:
    """`make_train_chunk`'s chunk: calling it dispatches n steps (the last
    heavy) and returns their `ChunkMetrics` without waiting for them.
    `mode` names how (`chunk_mode`; a captured sharded step's segments).
    Each call is a tracer span (utils/trace.py) of what it ran: `chunk.eager`,
    `chunk.warmup` then `chunk.capture`, or `chunk.replay`; then `chunk.copy`."""

    def __init__(self, step: TrainStep, n: int, capture: bool, why: str):
        self.step, self.n, self.capture, self.why = step, n, capture, why
        self.state = step.chunk_state

    @property
    def mode(self) -> str:
        segments = self.state.segments
        if self.capture and segments is not None and self.step.mesh is not None:
            light, heavy = (len(segments[h].graphs) for h in (False, True))
            return f"captured ({self.why}: {light} segment{'s' * (light != 1)} light, {heavy} heavy)"
        return f"{'captured' if self.capture else 'eager'} ({self.why})"

    def log_mode(self) -> None:
        if self.state.mode != self.mode:
            self.state.mode = self.mode
            log.info(f"train chunk: {self.mode}")

    def __call__(self) -> ChunkMetrics:
        st, n = self.state, self.n
        st.row.zero_()
        if not self.capture:
            with trace.span("chunk.eager", steps=n):
                for i in range(n):
                    st.step_and_record(heavy=i == n - 1)
            trace.count("eager_steps", n)
        elif st.segments is None:
            # warm-up, as torch's CUDA-graph recipe asks: on a side stream,
            # as real training (a sharded step with its collectives); then
            # the capture
            with trace.span("chunk.warmup", steps=n):
                main = torch.cuda.current_stream(self.step.device)
                side = torch.cuda.Stream(self.step.device)
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    for i in range(n):
                        st.step_and_record(heavy=i == n - 1)
                main.wait_stream(side)
            trace.count("eager_steps", n)
            with trace.span("chunk.capture"):
                st.capture()
            self.log_mode()
        else:
            with trace.span("chunk.replay", steps=n):
                st.check_bound()
                st.segments[False].replay(n - 1)
                st.segments[True].replay(1)
            trace.count("replays", n)
        with trace.span("chunk.copy"):
            return self._read(n)

    def _read(self, n: int) -> ChunkMetrics:
        st = self.state
        if self.step.device.type != "cuda":
            return ChunkMetrics(st.keys, st.rows[:n].clone(), None)
        host = torch.empty((n, len(st.keys)), dtype=torch.float32, pin_memory=True)
        host.copy_(st.rows[:n], non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return ChunkMetrics(st.keys, host, event)


def make_train_chunk(step: TrainStep, n: int, capture: bool | None = None) -> TrainChunk:
    """Twin of marf_tpu's `make_train_chunk` (a `lax.scan` of n steps, under
    `shard_map` on a mesh): a chunk of n steps of `step`, the last heavy,
    whose metrics land in the step's rows [n, k] on the device. On a card
    (`chunk_mode`) the first chunk runs eagerly as real training (with the
    kernels' build and warm-up), then captures a light and a heavy step
    (`_Segments`); every later chunk, of any length up to the first ones',
    replays the light one n - 1 times and the heavy one once. A capture that
    fails raises. capture=False runs eagerly (the oracle), as the CPU does."""
    capture, why = chunk_mode(step, capture)
    if n < 1:
        raise ValueError(f"a chunk of {n} steps")
    if step.chunk_state is None:
        step.chunk_state = _ChunkState(step)
    step.chunk_state.reserve(n)
    chunk = TrainChunk(step, n, capture, why)
    chunk.log_mode()
    return chunk


def run_chunk(step: TrainStep, start: int, n: int) -> dict[str, np.ndarray]:
    """The eager oracle: steps [start, start + n), the counter set to start,
    their metrics read back with one device->host copy: {name: [n] array}."""
    step.set_step(start)
    return make_train_chunk(step, n, capture=False)().result()


def chunk_schedule(max_iter: int, freq_scalar: int, freq_vis: int, freq_ckpt: int | None = None) -> int:
    """Chunk length: the largest step count whose boundaries hit every
    scalar-log, vis and (if set) checkpoint cadence point."""
    c = math.gcd(int(freq_scalar), int(freq_vis))
    if freq_ckpt:
        c = math.gcd(c, int(freq_ckpt))
    return max(1, min(c, max_iter))
