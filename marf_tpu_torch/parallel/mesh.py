"""The ranks of a pixel-sharded run and their collectives (twin of
marf_tpu/parallel/mesh.py).

marf_tpu lays a 1-axis `jax.sharding.Mesh` over the chips of one process;
here each rank is a process of its own under `torch.distributed`, and a
`Mesh` records this process's place in it: its rank, the world size, its
device and the backend (NCCL with rank r on `cuda:r`, or gloo: on the CPU,
or with every rank sharing `cuda:0`). Parameters and optimizer state are
replicated; the flat pixel axis is sharded in contiguous column blocks
(engine/step.py).

`make_mesh_2d` checks a layout as marf_tpu's 2-axis mesh (`batch`,
`data`: n_batch blocks of images by n_pixel blocks of their pixels) and
keeps the 1-D mesh: the port shards every layout as contiguous blocks of
the flat axis, so rank r holds the same count of positions as rank (r //
n_pixel, r % n_pixel) of marf_tpu's mesh (the same positions when each
batch block is one image), and the step's sums do not depend on which.

What marf_tpu `psum`s or tiles with `all_gather` over ICI is summed here by
one `all_reduce` of a packed float32 buffer (`psum`): a tiled column gather
is the sum of zero-filled full buffers into which each rank wrote its block
(`place_columns`), exact because adding zeros is exact, so one code path
serves both backends (gloo has no `all_gather` on CUDA tensors). A step's
sums go through its `Collectives`, which a captured chunk uses to split the
step into CUDA graphs at them (engine/step.py `_Segments`).
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

# seconds a rank waits for the others at the rendezvous and in a gloo collective
INIT_TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place among the ranks."""

    rank: int
    world_size: int
    device: torch.device
    backend: str


def init_mesh(rank: int, world_size: int, device: torch.device, backend: str, init_method: str = "env://",
              timeout_s: float = INIT_TIMEOUT_S) -> Mesh:
    """Join the process group and return this rank's Mesh; on CUDA the rank's
    device becomes the current one. The group's timeout bounds the
    rendezvous (and, under gloo, every collective), so a lost rank fails
    the others instead of hanging them."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh(rank, world_size, device, backend)


def make_mesh_2d(mesh: Mesh, n_batch: int, n_pixel: int, batch_size: int) -> Mesh:
    """The ranks of `mesh` as marf_tpu's 2-axis mesh (`make_mesh_2d`), images
    over n_batch blocks, pixels over n_pixel: `mesh` itself (module
    docstring). Raises ValueError unless n_batch x n_pixel is the world size
    and the B images divide over the batch axis."""
    if n_batch * n_pixel != mesh.world_size:
        raise ValueError(f"a {n_batch} x {n_pixel} mesh needs {n_batch * n_pixel} ranks, the world has "
                         f"{mesh.world_size}")
    if batch_size % n_batch:
        raise ValueError(f"B = {batch_size} images do not divide over the {n_batch} blocks of the batch axis")
    return mesh


class Collectives:
    """The sums of one rank's step. `psum` packs a step's parts into one
    buffer and all-reduces it; `issued` lists the collectives issued since
    it was last cleared, each as its parts' (name, shapes), so that a
    captured step can be held to the eager one's. While `capture` is set
    (engine/step.py `_Segments`, only inside a chunk's capture), `psum`
    runs no collective: it builds the buffer in the graph being captured,
    hands it to `capture.cut`, which ends that graph and begins the next,
    and returns the views; the replay all-reduces the buffer between the
    two graphs. Every rank captures on its own, so a capture never waits
    on another rank."""

    def __init__(self):
        self.issued = []
        self.capture = None

    def psum(self, parts: dict) -> dict:
        """Each float32 tensor of `parts` ({name: [tensors]}) summed over the
        ranks, by one all_reduce of them all packed into a flat buffer: {name:
        [sums]}, views of that buffer. Every rank gets the same bits."""
        tensors = [t for ts in parts.values() for t in ts]
        if any(t.dtype != torch.float32 for t in tensors):
            raise TypeError(f"psum takes float32 tensors, got {sorted({str(t.dtype) for t in tensors})}")
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.issued.append(tuple((name, tuple(tuple(t.shape) for t in ts)) for name, ts in parts.items()))
        if self.capture is None:
            dist.all_reduce(flat)
        else:
            self.capture.cut(flat)
        out, i = {}, 0
        for name, ts in parts.items():
            out[name] = []
            for t in ts:
                out[name].append(flat[i : i + t.numel()].view(t.shape))
                i += t.numel()
        return out


def place_columns(block: torch.Tensor, n_cols: int, start: int) -> torch.Tensor:
    """[C, n_cols] zeros with a rank's column block [C, n] written at columns
    [start, start + n): `psum` of these is the tiled gather."""
    full = block.new_zeros((block.shape[0], n_cols))
    full[:, start : start + block.shape[1]] = block
    return full


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Overwrite every rank's parameters with rank `src`'s, in one broadcast."""
    params = list(module.parameters())
    with torch.no_grad():
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        dist.broadcast(flat, src=src)
        i = 0
        for p in params:
            p.copy_(flat[i : i + p.numel()].view(p.shape))
            i += p.numel()


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank (no-op without a mesh)."""
    if mesh is not None:
        if mesh.backend == "nccl":
            dist.barrier(device_ids=[mesh.device.index])
        else:
            dist.barrier()
