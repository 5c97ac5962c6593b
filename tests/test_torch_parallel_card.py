"""Two ranks sharing one card (the launcher's share_device: both on cuda:0
over gloo) against one rank on the card, through `marf_tpu_torch.train.main`
at the tiny size of tests/test_torch_parallel.py. It imports no module of
marf_tpu, so it is collected on the card's machine, which lacks flax:

    python -m pytest tests/test_torch_parallel_card.py -m cuda
"""

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
