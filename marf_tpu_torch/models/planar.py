"""The planar bundle-adjusting graph: per-image sl(3) warps + the neural image
+ the optional implicit mask head (twin of marf_tpu/models/planar.py,
reference model/planar.py:296-391).

`Graph` holds the trainable parameters: the neural-image MLP, the [B, 8]
zero-initialized warp (reference :310-311) and, with `use_implicit_mask`, the
mask head (one shared, or one per image) and the view embedding.
`graph_forward` and `graph_loss` are the autograd path; the fused CUDA steps
(engine/step.py) compute the same loss and gradients with the kernels.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from marf_tpu_torch.models.implicit_mask import ImplicitMask, init_view_embedding, mask_head_inputs_cf
from marf_tpu_torch.models.neural_image import NeuralImage, NeuralImageConfig
from marf_tpu_torch.ops.filters import compute_edges
from marf_tpu_torch.ops.grid import GridSpec, normalized_pixel_grid
from marf_tpu_torch.ops.losses import alpha_schedule, mask_counterweight, mse, render_loss
from marf_tpu_torch.ops.warp import warp_grid_cf_flat
from marf_tpu_torch.utils.console import log


@dataclasses.dataclass(frozen=True)
class PlanarConfig:
    """Static configuration of the planar experiment (keys of planar.yaml)."""

    H: int = 360
    W: int = 480
    patch_H: int = 180
    patch_W: int = 240
    batch_size: int = 5
    max_iter: int = 3000
    use_cropped_images: bool = True
    use_masks: bool = True
    use_implicit_mask: bool = False
    build_single_masks: bool = False  # one mask head per image instead of a shared one
    # fix mode: optimize the view embedding (the reference never does,
    # model/planar.py:89-96)
    train_view_embedding: bool = False
    N_vocab: int = 1500
    mask_quantize_levels: int = 1  # 1 = the reference's {0,1} image.long() quirk
    use_edges: bool = True
    alpha_initial: float = 0.0
    alpha_final: float = 1.0
    differentiable_edges: bool = False  # False = reference's stop-gradient edge term
    warp_type: str = "homography"
    warp_dof: int = 8
    fix_first: bool = True
    arch: NeuralImageConfig = dataclasses.field(default_factory=NeuralImageConfig)
    # the fused CUDA train step: 'auto' (on under CUDA when the config is in
    # scope), 'on', 'off'
    fused_step: str = "auto"
    # homography warp inside the rgb kernel (K1); 'off', or more than 8
    # images, runs K2 on warped coordinates
    fused_warp: str = "auto"
    # implicit-mask column dedup of the shared head (K3 -> K1/K2 -> K4):
    # 'auto' and 'on' run it, 'off' runs the shared head on all N columns
    # (K5 -> K6); per-image heads always take K5 -> K6
    fused_dedup: str = "auto"
    # metric-only work (the gradient-blocked edge term of the fused path,
    # Homography_Error) only at chunk-final steps: 'auto' (on under CUDA), 'on', 'off'
    lazy_metrics: str = "auto"
    # loss weights in log10 scale; None disables a term (planar.yaml:67-71)
    w_render: float | None = 0.0
    w_rgb: float | None = 0.0
    w_edge: float | None = 0.0
    w_mask: float | None = 0.0

    def __post_init__(self):
        if self.warp_type != "homography" or self.warp_dof != 8:
            raise ValueError("only 8-dof homography warps are supported (reference warp.py:72-80)")

    @property
    def grid_spec(self) -> GridSpec:
        return GridSpec(H=self.H, W=self.W, patch_H=self.patch_H, patch_W=self.patch_W)

    @property
    def map_hw(self) -> tuple[int, int]:
        """Spatial dims of prediction maps (reference model/planar.py:313-314)."""
        return (self.patch_H, self.patch_W) if self.use_cropped_images else (self.H, self.W)

    @property
    def loss_weight(self) -> dict:
        return {"render": self.w_render, "rgb": self.w_rgb, "edge": self.w_edge, "mask": self.w_mask}

    @classmethod
    def from_options(cls, opt) -> "PlanarConfig":
        """Build from a parsed options AttrDict (reference yaml key layout)."""
        lw = opt.get("loss_weight", {})
        tpu_opts = opt.get("tpu") or {}

        def tristate(key: str) -> str:
            # the config DSL yaml-parses `--tpu.x=on` to True
            v = tpu_opts.get(key, "auto")
            if isinstance(v, bool):
                return "on" if v else "off"
            return str(v).lower()

        arch = NeuralImageConfig(
            layers=tuple(opt.arch.layers),
            skip=tuple(opt.arch.get("skip", []) or []),
            posenc_L=(opt.arch.posenc.L_2D if opt.arch.get("posenc") else None),
            barf_c2f=(tuple(opt.barf_c2f) if opt.get("barf_c2f") else None),
            compute_dtype=str(tpu_opts.get("compute_dtype", "float32")),
        )
        if tpu_opts.get("fused_streams"):
            log.info("tpu.fused_streams is a TPU knob (column streams per Pallas grid step); ignored")
        return cls(
            H=opt.H,
            W=opt.W,
            patch_H=opt.patch_H,
            patch_W=opt.patch_W,
            batch_size=opt.batch_size,
            max_iter=opt.max_iter,
            use_cropped_images=bool(opt.get("use_cropped_images", True)),
            use_masks=bool(opt.get("use_masks", True)),
            use_implicit_mask=bool(opt.get("use_implicit_mask", False)),
            build_single_masks=bool(opt.get("build_single_masks", False)),
            train_view_embedding=bool((opt.get("optim") or {}).get("train_view_embedding", False)),
            N_vocab=int(opt.get("N_vocab", 1500)),
            mask_quantize_levels=int(tpu_opts.get("mask_quantize_levels", 1)),
            use_edges=bool(opt.get("use_edges", True)),
            alpha_initial=float(opt.get("alpha_initial", 0.0)),
            alpha_final=float(opt.get("alpha_final", 1.0)),
            differentiable_edges=bool(tpu_opts.get("differentiable_edges", False)),
            warp_type=opt.warp.type,
            warp_dof=opt.warp.dof,
            fix_first=bool(opt.warp.get("fix_first", True)),
            arch=arch,
            fused_step=tristate("fused_step"),
            fused_warp=tristate("fused_warp"),
            fused_dedup=tristate("fused_dedup"),
            lazy_metrics=tristate("lazy_metrics"),
            w_render=lw.get("render", 0.0),
            w_rgb=lw.get("rgb", 0.0),
            w_edge=lw.get("edge", 0.0),
            w_mask=lw.get("mask", 0.0),
        )


def _kernel_scope(cfg: PlanarConfig) -> list[str]:
    """What keeps the rgb kernels (K1, K2) from a config."""
    out = []
    if cfg.arch.skip:
        out.append("arch.skip: the kernel has no skip re-concat")
    if cfg.w_render is None:
        out.append("loss_weight.render is disabled")
    if cfg.differentiable_edges:
        out.append("differentiable_edges needs autograd through the edge term")
    if len(cfg.arch.layers) < 3 or cfg.arch.layers[-1] != 3:
        out.append("the kernel takes at least one hidden layer and 3 outputs")
    return out


def _gate(cfg: PlanarConfig, device: torch.device, out_of_scope: list[str]) -> bool:
    """'on' raises for a config outside the kernels' scope; 'auto' takes the
    autograd path for it, with a log line, and is on under CUDA otherwise."""
    if out_of_scope:
        if cfg.fused_step == "on":
            raise NotImplementedError("fused_step=on: " + "; ".join(out_of_scope))
        log.info("fused_step=auto: using the autograd step (" + "; ".join(out_of_scope) + ")")
        return False
    return cfg.fused_step == "on" or device.type == "cuda"


def use_fused_step(cfg: PlanarConfig, device: torch.device) -> bool:
    """Whether a fixed-mask config runs the fused CUDA step: K1, or K2 under
    fused_warp=off or more than 8 images."""
    if cfg.fused_step == "off" or cfg.use_implicit_mask:
        return False
    return _gate(cfg, device, _kernel_scope(cfg))


def use_fused_implicit(cfg: PlanarConfig, device: torch.device) -> bool:
    """Whether an implicit-mask config runs a fused pipeline: the dedup one
    (K3 -> K1 or K2 -> K4, see `use_fused_dedup`) or K5 -> K6 for per-image
    heads and the shared head without dedup. Both need the factoring to be
    exact: a frozen view embedding and the {0,1} quantization."""
    if cfg.fused_step == "off" or not cfg.use_implicit_mask:
        return False
    out_of_scope = _kernel_scope(cfg)
    if cfg.train_view_embedding:
        out_of_scope.append("optim.train_view_embedding: the factored mask input needs a frozen view embedding")
    if cfg.mask_quantize_levels != 1:
        out_of_scope.append("tpu.mask_quantize_levels != 1: the factored mask input needs the {0,1} quantization")
    return _gate(cfg, device, out_of_scope)


def use_fused_dedup(cfg: PlanarConfig, device: torch.device) -> bool:
    """Whether the fused implicit step deduplicates the mask-head columns
    (twin of marf_tpu's): the shared head only, unless fused_dedup=off.
    Per-image heads have no duplicate columns, so fused_dedup=on is ignored
    for them with a log line. marf_tpu's TPU hardware-validation gate is not
    ported: on the card 'auto' means on."""
    if cfg.build_single_masks:
        if cfg.fused_dedup == "on":
            log.warn("tpu.fused_dedup=on ignored: column dedup covers the shared head only "
                     "(per-image heads have no duplicate columns)")
        return False
    return cfg.fused_dedup != "off" and use_fused_implicit(cfg, device)


def use_lazy_metrics(cfg: PlanarConfig, device: torch.device) -> bool:
    """Metric-only work (the gradient-blocked edge term in the fused path,
    the post-update Homography_Error) runs only at chunk-final steps;
    intermediate rows report 0. It never feeds an update."""
    if cfg.lazy_metrics in ("on", "off"):
        return cfg.lazy_metrics == "on"
    return device.type == "cuda"


class Graph(nn.Module):
    """Trainable parameters: `neural_image` (the MLP), `warp` [B, 8] and, with
    implicit masks, `implicit_mask` (an ImplicitMask, or a ModuleList of B
    under build_single_masks) and `view_embedding` [N_vocab, 128], which
    takes gradients only under optim.train_view_embedding."""

    def __init__(self, cfg: PlanarConfig, generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.neural_image = NeuralImage(cfg.arch, generator=generator, device=device)
        self.warp = nn.Parameter(torch.zeros(cfg.batch_size, cfg.warp_dof, device=device))
        if cfg.use_implicit_mask:
            if cfg.build_single_masks:
                self.implicit_mask = nn.ModuleList(ImplicitMask(generator, device) for _ in range(cfg.batch_size))
            else:
                self.implicit_mask = ImplicitMask(generator, device)
            self.view_embedding = nn.Parameter(
                init_view_embedding(cfg.N_vocab, generator, device), requires_grad=cfg.train_view_embedding
            )
        # the constant unwarped [HW, 2] grid (the reference rebuilds it every step)
        grid = normalized_pixel_grid(cfg.grid_spec, crop=cfg.use_cropped_images, device=device)
        self.register_buffer("grid", grid, persistent=False)


def graph_forward(graph: Graph, data: dict, cfg: PlanarConfig, progress: torch.Tensor) -> dict:
    """Forward pass (reference Graph.forward, model/planar.py:329-353):
    rgb_prediction [B, HW, 3], rgb_prediction_map [B, 3, h, w]; with edges
    on, edge_prediction [B, 3, h, w]; with implicit masks, mask_prediction
    [B, HW, 1] and mask_prediction_map [B, 1, h, w]. The mask-head inputs are
    data["mask_head_inputs_cf"] when the step precomputed them ([426, B*HW]
    for the shared head, [B, 426, HW] per image)."""
    h, w = cfg.map_hw
    B = cfg.batch_size
    warped = warp_grid_cf_flat(graph.grid, graph.warp)  # [2, B*HW]
    rgb_flat = graph.neural_image(warped, progress)  # [3, B*HW]
    if not cfg.use_implicit_mask:
        return map_outputs(cfg, rgb_flat)
    inputs_cf = data.get("mask_head_inputs_cf")
    if inputs_cf is None:
        inputs_cf = mask_head_inputs_cf(graph.view_embedding, data["rgb"], graph.grid, cfg.mask_quantize_levels)
    if not cfg.build_single_masks:
        if inputs_cf.dim() == 3:  # batch folded into the pixel axis, columns b*HW + i
            inputs_cf = inputs_cf.transpose(0, 1).reshape(inputs_cf.shape[1], -1)
        return map_outputs(cfg, rgb_flat, graph.implicit_mask(inputs_cf))  # mask [1, B*HW]
    out = map_outputs(cfg, rgb_flat)
    mask_cf = torch.stack([head(x) for head, x in zip(graph.implicit_mask, inputs_cf)])  # [B, 1, HW]
    out["mask_prediction"] = mask_cf.transpose(1, 2)
    out["mask_prediction_map"] = mask_cf.reshape(B, 1, h, w)
    return out


def map_outputs(cfg: PlanarConfig, rgb_flat: torch.Tensor, mask_flat: torch.Tensor | None = None) -> dict:
    """`graph_forward`'s outputs from the flat maps in column order b*HW + i:
    from rgb [3, B*HW] the rgb prediction, its map and, with edges on, the
    edge prediction; from a mask [1, B*HW] the mask prediction and its map."""
    h, w = cfg.map_hw
    B = cfg.batch_size
    rgb_map = rgb_flat.reshape(3, B, h, w).permute(1, 0, 2, 3)
    out = {"rgb_prediction": rgb_flat.reshape(3, B, h * w).permute(1, 2, 0), "rgb_prediction_map": rgb_map}
    if cfg.use_edges:
        out["edge_prediction"] = compute_edges(rgb_map, differentiable=cfg.differentiable_edges)
    if mask_flat is not None:
        out["mask_prediction"] = mask_flat.reshape(1, B, h * w).permute(1, 2, 0)
        out["mask_prediction_map"] = mask_flat.reshape(1, B, h, w).permute(1, 0, 2, 3)
    return out


def graph_loss(outputs: dict, data: dict, cfg: PlanarConfig, step: torch.Tensor) -> dict:
    """Composite loss (reference Graph.compute_loss, model/planar.py:355-380);
    `step` is the 0-based step as an integer tensor."""
    zero = torch.zeros((), dtype=torch.float32, device=step.device)
    alpha = alpha_schedule(step, cfg.max_iter, cfg.alpha_initial, cfg.alpha_final) if cfg.use_edges else zero
    if cfg.w_render is None:
        return {}
    implicit = cfg.use_implicit_mask
    if implicit:
        rgb_masks = outputs["mask_prediction_map"]
    else:
        rgb_masks = data["masks"] if cfg.use_masks else None
    rgb_loss = mse(outputs["rgb_prediction_map"], data["rgb"], rgb_masks)
    if cfg.use_edges:
        edge_masks = outputs["mask_prediction_map"] if implicit else data.get("masks_eroded")
        edge_loss = mse(outputs["edge_prediction"], data["edges"], edge_masks)
    else:
        edge_loss = zero
    mask_loss = mask_counterweight(outputs["mask_prediction_map"]) if implicit else zero
    return {
        "render": render_loss(rgb_loss, edge_loss, mask_loss, alpha),
        "rgb": rgb_loss,
        "mask": mask_loss,
        "edge": edge_loss,
    }
