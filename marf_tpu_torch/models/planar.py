"""The planar bundle-adjusting graph: per-image sl(3) warps + the neural image
(twin of marf_tpu/models/planar.py, reference model/planar.py:296-391).

`Graph` holds the trainable parameters: the neural-image MLP and the [B, 8]
zero-initialized warp (reference :310-311). `graph_forward` and `graph_loss`
are the autograd path; the fused CUDA step (engine/step.py) computes the same
loss and gradients in one kernel call.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from marf_tpu_torch.models.neural_image import NeuralImage, NeuralImageConfig
from marf_tpu_torch.ops.cuda.fused_step import MAX_IMAGES as FUSED_MAX_IMAGES
from marf_tpu_torch.ops.filters import compute_edges
from marf_tpu_torch.ops.grid import GridSpec, normalized_pixel_grid
from marf_tpu_torch.ops.losses import alpha_schedule, mse, render_loss
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
    # homography warp inside the fused kernel; 'off' needs kernel K2
    fused_warp: str = "auto"
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
        if self.use_implicit_mask:
            raise NotImplementedError(
                "use_implicit_mask: the implicit-mask model is not ported yet (ROADMAP.md Queue 1, slice 2)"
            )

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
            lazy_metrics=tristate("lazy_metrics"),
            w_render=lw.get("render", 0.0),
            w_rgb=lw.get("rgb", 0.0),
            w_edge=lw.get("edge", 0.0),
            w_mask=lw.get("mask", 0.0),
        )


def use_fused_step(cfg: PlanarConfig, device: torch.device) -> bool:
    """Whether the step runs the fused CUDA kernel (K1). 'on' raises for a
    config outside the kernel's scope; 'auto' takes the autograd path for
    it, with a log line, and is on under CUDA otherwise."""
    if cfg.fused_step == "off":
        return False
    out_of_scope = []
    if cfg.fused_warp == "off" or cfg.batch_size > FUSED_MAX_IMAGES:
        out_of_scope.append(
            f"fused_warp=off or batch_size>{FUSED_MAX_IMAGES} needs kernel K2 (ROADMAP.md Queue 2)"
        )
    if cfg.arch.skip:
        out_of_scope.append("arch.skip: the kernel has no skip re-concat")
    if cfg.w_render is None:
        out_of_scope.append("loss_weight.render is disabled")
    if cfg.differentiable_edges:
        out_of_scope.append("differentiable_edges needs autograd through the edge term")
    if len(cfg.arch.layers) < 3 or cfg.arch.layers[-1] != 3:
        out_of_scope.append("the kernel takes at least one hidden layer and 3 outputs")
    if out_of_scope:
        if cfg.fused_step == "on":
            raise NotImplementedError("fused_step=on: " + "; ".join(out_of_scope))
        log.info("fused_step=auto: using the autograd step (" + "; ".join(out_of_scope) + ")")
        return False
    return cfg.fused_step == "on" or device.type == "cuda"


def use_lazy_metrics(cfg: PlanarConfig, device: torch.device) -> bool:
    """Metric-only work (the gradient-blocked edge term in the fused path,
    the post-update Homography_Error) runs only at chunk-final steps;
    intermediate rows report 0. It never feeds an update."""
    if cfg.lazy_metrics in ("on", "off"):
        return cfg.lazy_metrics == "on"
    return device.type == "cuda"


class Graph(nn.Module):
    """Trainable parameters: `neural_image` (the MLP) and `warp` [B, 8]."""

    def __init__(self, cfg: PlanarConfig, generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.neural_image = NeuralImage(cfg.arch, generator=generator, device=device)
        self.warp = nn.Parameter(torch.zeros(cfg.batch_size, cfg.warp_dof, device=device))
        # the constant unwarped [HW, 2] grid (the reference rebuilds it every step)
        grid = normalized_pixel_grid(cfg.grid_spec, crop=cfg.use_cropped_images, device=device)
        self.register_buffer("grid", grid, persistent=False)


def graph_forward(graph: Graph, data: dict, cfg: PlanarConfig, progress: torch.Tensor) -> dict:
    """Forward pass (reference Graph.forward, model/planar.py:329-353):
    rgb_prediction [B, HW, 3], rgb_prediction_map [B, 3, h, w] and, with
    edges on, edge_prediction [B, 3, h, w]."""
    h, w = cfg.map_hw
    B = cfg.batch_size
    warped = warp_grid_cf_flat(graph.grid, graph.warp)  # [2, B*HW]
    rgb_flat = graph.neural_image(warped, progress)  # [3, B*HW]
    rgb_map = rgb_flat.reshape(3, B, h, w).permute(1, 0, 2, 3)
    out = {
        "rgb_prediction": rgb_flat.reshape(3, B, h * w).permute(1, 2, 0),
        "rgb_prediction_map": rgb_map,
    }
    if cfg.use_edges:
        out["edge_prediction"] = compute_edges(rgb_map, differentiable=cfg.differentiable_edges)
    return out


def graph_loss(outputs: dict, data: dict, cfg: PlanarConfig, step: torch.Tensor) -> dict:
    """Composite loss (reference Graph.compute_loss, model/planar.py:355-380);
    `step` is the 0-based step as an integer tensor."""
    zero = torch.zeros((), dtype=torch.float32, device=step.device)
    alpha = alpha_schedule(step, cfg.max_iter, cfg.alpha_initial, cfg.alpha_final) if cfg.use_edges else zero
    if cfg.w_render is None:
        return {}
    rgb_masks = data["masks"] if cfg.use_masks else None
    rgb_loss = mse(outputs["rgb_prediction_map"], data["rgb"], rgb_masks)
    if cfg.use_edges:
        edge_loss = mse(outputs["edge_prediction"], data["edges"], data.get("masks_eroded"))
    else:
        edge_loss = zero
    return {
        "render": render_loss(rgb_loss, edge_loss, zero, alpha),
        "rgb": rgb_loss,
        "mask": zero,
        "edge": edge_loss,
    }
