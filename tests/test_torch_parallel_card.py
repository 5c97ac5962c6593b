"""Two ranks sharing one card (the launcher's share_device: both on cuda:0
over gloo) against one rank on the card, through `marf_tpu_torch.train.main`
at the tiny size of tests/test_torch_parallel.py, and each sharded path's
chunks captured in segments against eager ones, through the rank body. It
imports no module of marf_tpu, so it is collected on the card's machine,
which lacks flax:

    python -m pytest tests/test_torch_parallel_card.py -m cuda
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import numpy as np
import pytest
import torch

from marf_tpu_torch.train import main

TINY = ["--H=32", "--W=64", "--patch_H=16", "--patch_W=32", "--batch_size=3", "--arch.layers=[null,64,64,3]",
        "--arch.posenc.L_2D=4", "--barf_c2f=[0,0.4]", "--dataset=synthetic", "--seed=3", "--tb="]


def history(hist) -> dict:
    return {k: np.concatenate([h[k] for h in hist]) for k in hist[0]}


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [(), ("--use_implicit_mask", "--use_masks=false", "--N_vocab=8")],
                         ids=["fixed", "dedup"])
def test_two_ranks_sharing_one_card_match_one_rank(tmp_path, monkeypatch, extra):
    """10 steps on 2 ranks within marf_tpu's mesh tolerance (rtol 2e-5) of
    1 rank, the ranks' parameters and Adam state bitwise equal, each rank
    launching each kernel of its path once per step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the card: python -m pytest tests/test_torch_parallel_card.py "
                    "-m cuda)")
    monkeypatch.setenv("MARF_YES", "1")
    args = lambda name, *more: ["--model=planar", "--yaml=planar", f"--output_root={tmp_path}", f"--name={name}",
                                "--max_iter=10", "--freq.scalar=10", "--freq.vis=10", "--tpu.fused_step=on", *TINY,
                                *extra, *more]
    two = main(args("two", "--tpu.n_devices=2"), share_device=True, timeout_s=300)
    one = main(args("one"))
    assert [r["device"] for r in two] == ["cuda:0", "cuda:0"] and two[0]["backend"] == "gloo"
    assert two[0]["digest"] == two[1]["digest"]
    assert two[0]["launches"] == two[1]["launches"] and set(two[0]["launches"].values()) == {10}
    h2, h1 = history(two[0]["history"]), history(one.history)
    for k in ("all", "loss_rgb", "PSNR"):
        np.testing.assert_allclose(h2[k], h1[k], rtol=2e-5, atol=1e-7, err_msg=k)


# the sharded paths captured in segments: (id, extra flags, each kernel's launches per rank and step)
CAPTURED = [
    ("fixed", (), {"fused_train_kernel_warp": 1}),
    ("dedup", ("--use_implicit_mask", "--use_masks=false", "--N_vocab=8"),
     {"fused_mask_forward": 1, "fused_train_kernel_warp": 1, "fused_mask_backward_g": 1}),
    ("heads", ("--use_implicit_mask", "--use_masks=false", "--N_vocab=8", "--build_single_masks"),
     {"fused_implicit_train_kernel": 1, "fused_mask_backward_g": 1}),
    ("autograd", (), {}),  # fused_step=off
]
CAPTURED_STEPS, CAPTURED_CHUNK = 13, 4


@pytest.mark.cuda
def test_sharded_chunk_captured_in_segments_is_bitwise_eager(tmp_path, monkeypatch):
    """Each path's rank body (`parallel/sharded.py` `train_steps`: step 1
    eager, then chunks of 4, the first of them the warm-up and the capture,
    two replayed) on 2 ranks sharing cuda:0 over gloo, captured in segments
    and eager from the same init: every step's metrics and the parameters
    and optimizer state bitwise equal, across ranks too; each kernel once
    per rank and step through the replays. Per-image heads at B = 3: 1 | 2
    images per rank."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (run on the card: python -m pytest tests/test_torch_parallel_card.py "
                    "-m cuda)")
    from marf_tpu_torch.engine.trainer import Model
    from marf_tpu_torch.parallel import launch
    from marf_tpu_torch.parallel.sharded import train_steps
    from marf_tpu_torch.utils.config import parse_arguments, set_opt

    monkeypatch.setenv("MARF_YES", "1")
    calls = []
    for cid, extra, _ in CAPTURED:
        argv = ["--model=planar", "--yaml=planar", "--cpu", f"--output_root={tmp_path}", f"--name={cid}",
                f"--max_iter={CAPTURED_STEPS}", f"--tpu.fused_step={'off' if cid == 'autograd' else 'on'}", *TINY,
                *extra]
        m = Model(set_opt(parse_arguments(argv), interactive=False))
        m.load_dataset()
        m.build_networks()
        args = (m.cfg, m.graph.state_dict(), m.data, CAPTURED_STEPS, dict(m.opt.optim), m.use_homographies)
        calls += [(train_steps, args, {"capture": capture, "chunk": CAPTURED_CHUNK}) for capture in (None, False)]
    ranks = launch.spawn(launch.run_each, 2, (calls,), share_device=True, timeout_s=300)
    for i, (cid, _, per_step) in enumerate(CAPTURED):
        cap, eag = ([r[2 * i + j] for r in ranks] for j in (0, 1))
        for c, e in zip(cap, eag):
            assert c["mode"].startswith("captured (2 ranks, gloo: ") and e["mode"] == "eager (capture=False)", cid
            assert c["layout"].startswith("sharded over 2 ranks"), (cid, c["layout"])
            assert c["launches"] == e["launches"] == {k: v * CAPTURED_STEPS for k, v in per_step.items()}, cid
            assert c["digest"] == e["digest"] == cap[0]["digest"], cid
            for k in e["metrics"]:
                np.testing.assert_array_equal(c["metrics"][k], e["metrics"][k], err_msg=f"{cid} {k}")
