"""The port's on-disk planar loader against marf_tpu's on the CPU.

A fixture in the `data/planar/<set>` layout (`i.png`, `i-m.png` with
occlusion = 1, `gt.png`, `H_0_i.mat`) is written into tmp_path from the
port's synthetic scene at the tiny size (32x64 photos, 3 images) by
`save_planar_dataset`. Both packages read it back: every array is equal
(the same PIL/cv2/numpy code), the normalized homographies `gt_hom` within
rtol=1e-5 (float32 matmul order of the normalization).
"""

import torch_threads  # noqa: F401  (first: the CPU thread budget of this worker)

import os
import shutil

import numpy as np
import pytest
import torch

from marf_tpu.data import planar as jdata
from marf_tpu_torch.data import planar as tdata
from test_torch_models import cfg_pair

NAME = "fixture"


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """{True: root with the .mat files, False: root without them}."""
    _, tcfg = cfg_pair(use_cropped_images=False)
    raw = tdata.synthesize_planar_dataset(tcfg, seed=3)
    full = str(tmp_path_factory.mktemp("with_mat"))
    tdata.save_planar_dataset(raw, os.path.join(full, NAME), tcfg.H, tcfg.W)
    bare = str(tmp_path_factory.mktemp("without_mat"))
    shutil.copytree(os.path.join(full, NAME), os.path.join(bare, NAME), ignore=shutil.ignore_patterns("*.mat"))
    return {True: full, False: bare}


def assert_same_dataset(ours: dict, ref: dict):
    assert set(ours) == set(ref)
    for k in ref:
        if ref[k] is None:
            assert ours[k] is None, k
        elif k == "gt_hom":
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5, atol=1e-7)
        else:
            assert ours[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


@pytest.mark.parametrize("mats", [True, False])
@pytest.mark.parametrize("use_masks", [True, False])
@pytest.mark.parametrize("crop", [True, False])
def test_load_planar_dataset_equals_jax(roots, crop, use_masks, mats, capsys):
    jcfg, tcfg = cfg_pair(use_cropped_images=crop)
    kw = dict(root=roots[mats], use_masks=use_masks, use_homographies=True, use_edges=True)
    ref = jdata.load_planar_dataset(jcfg, NAME, **kw)
    capsys.readouterr()
    ours = tdata.load_planar_dataset(tcfg, NAME, **kw)
    assert ("disabling Homography_Error" in capsys.readouterr().out) == (not mats)
    assert_same_dataset(ours, ref)
    h, w = tcfg.map_hw
    assert ours["rgb"].shape == (3, 3, h, w) and ours["gt"].shape == (3, tcfg.H, tcfg.W)
    assert (ours["masks"] is not None) == use_masks and (ours["gt_hom"] is not None) == mats


def test_fixture_round_trip(roots):
    """What `save_planar_dataset` writes reads back as the synthetic set: the
    same masks and canvas, photos within one 8-bit step, gt_hom to float32."""
    _, tcfg = cfg_pair(use_cropped_images=False)
    raw = tdata.synthesize_planar_dataset(tcfg, seed=3)
    got = tdata.load_planar_dataset(tcfg, NAME, root=roots[True])
    np.testing.assert_array_equal(got["masks"], raw["masks"])
    np.testing.assert_array_equal(got["gt"], raw["gt"])
    np.testing.assert_allclose(got["rgb"], raw["rgb"], atol=1.0 / 255 + 1e-6)
    np.testing.assert_allclose(got["gt_hom"], raw["gt_hom"], rtol=1e-5, atol=1e-6)


def test_helpers_equal_jax(roots, tmp_path, rng):
    ddir = os.path.join(roots[True], NAME)
    for thumb in (None, (16, 32)):
        fps = [os.path.join(ddir, f"{i}-m.png") for i in range(3)]
        np.testing.assert_array_equal(tdata.load_images(fps, mode="L", invert_gray=True, thumbnail_hw=thumb),
                                      jdata.load_images(fps, mode="L", invert_gray=True, thumbnail_hw=thumb))
    np.testing.assert_array_equal(tdata.load_single_image(os.path.join(ddir, "gt.png"), "L"),
                                  jdata.load_single_image(os.path.join(ddir, "gt.png"), "L"))
    assert tdata.load_images(None) is None and tdata.load_homography([], 64, 32) is None
    with pytest.raises(TypeError):
        tdata.load_images(os.path.join(ddir, "0.png"))
    images = rng.rand(2, 3, 5, 7).astype(np.float32)
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    ours.mkdir(), ref.mkdir()
    names = [os.path.basename(p) for p in tdata.save_images(images, "x", str(ours))]
    assert names == [os.path.basename(p) for p in jdata.save_images(images, "x", str(ref))] == ["0-x.png", "1-x.png"]
    for n in names:
        assert (ours / n).read_bytes() == (ref / n).read_bytes()


def test_missing_dataset_raises(tmp_path):
    _, tcfg = cfg_pair()
    with pytest.raises(FileNotFoundError, match="not found"):
        tdata.load_planar_dataset(tcfg, "absent", root=str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tdata.resolve_data_root("absent")


@pytest.mark.parametrize("implicit", [False, True])
def test_model_loads_fixture_like_jax(roots, tmp_path, implicit):
    """`Model.load_dataset` on the fixture: the device arrays equal marf_tpu
    Model's (masks loaded for implicit masks without use_masks)."""
    from marf_tpu.engine.trainer import Model as JaxModel
    from marf_tpu_torch.engine.trainer import Model
    from test_torch_trainer import make_opt

    kw = dict(dataset=NAME, data={"root": roots[True]}, use_implicit_mask=implicit, use_masks=not implicit,
              N_vocab=8)
    jm = JaxModel(make_opt(tmp_path / "jax", **kw))
    jm.load_dataset()
    m = Model(make_opt(tmp_path / "torch", cpu=True, **kw))
    m.load_dataset()
    ref = {k: None if v is None else np.asarray(v) for k, v in jm.data.items()}
    ours = {k: None if v is None else v.numpy() for k, v in m.data.items()}
    assert_same_dataset(ours, ref)
    assert ours["masks"] is not None and m.use_homographies
    assert m.data["rgb"].dtype == torch.float32

