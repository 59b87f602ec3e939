"""The port's remaining helpers against the JAX package's on the same seeded
inputs: the optional losses (``losses/optional.py``), the offset targets
(``data/target_generators.py``), the integral-regression decode
(``ops/coords.py``), the named initializers (``models/weight_init.py``),
the IO and logging helpers (``utils/io_utils.py``,
``utils/logging_utils.py``) and ``python -m
fami_pose_torch.tools.convert_poseval``.

Tolerances. Losses, offset targets and decoded coordinates: rtol 1e-5 in
float32 (the port's (B, J, H, W) layout against JAX's (B, H, W, J), sums in
another order). Initializers, by distribution at 100,352 samples (a
64 x 32 x 7 x 7 conv weight; a 392 x 256 linear one): the mean within 4
standard errors of the distribution's, the standard deviation within 2%,
the support bounds exact; flax's samples of the same layer meet the same
bounds, so both draw from one distribution. IO, logging and the converter:
equal files and values.
"""

import json
import logging
import math
import os
import os.path as osp
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fami_pose_tpu.data.target_generators import (
    generate_offset_targets as jax_offset_targets,
)
from fami_pose_tpu.evaluation.convert import convert_dir as jax_convert_dir
from fami_pose_tpu.losses import optional as jax_optional
from fami_pose_tpu.models.weight_init import get_initializer as jax_initializer
from fami_pose_tpu.ops.coords import get_final_preds_coord as jax_coord
from fami_pose_tpu.utils import io_utils as jax_io
from fami_pose_tpu.utils import logging_utils as jax_logging
from fami_pose_torch.data.target_generators import generate_offset_targets
from fami_pose_torch.losses import optional
from fami_pose_torch.models.weight_init import TRUNCATED_STD, get_initializer
from fami_pose_torch.ops.coords import get_final_preds_coord
from fami_pose_torch.tools import convert_poseval
from fami_pose_torch.utils import io_utils, logging_utils
from test_convert import _annolist_fixture

RTOL = 1e-5


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


# -- optional losses ------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [1.0, 0.1])
def test_soft_argmax_matches_jax(temperature):
    rs = np.random.RandomState(0)
    hm = torch.from_numpy((rs.rand(2, 17, 12, 10) * 5).astype(np.float32))
    got = optional.soft_argmax(hm, temperature)
    ref = jax_optional.soft_argmax(jnp.asarray(_nhwc(hm)), temperature)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)
    assert got.shape == (2, 17, 2)


@pytest.mark.parametrize("weighted,sized", [(False, False), (True, True)])
def test_integral_and_structure_losses_match_jax(weighted, sized):
    rs = np.random.RandomState(1)
    hm = torch.from_numpy((rs.rand(3, 17, 16, 12) * 4).astype(np.float32))
    joints = (rs.rand(3, 17, 2) * [48, 64]).astype(np.float32)
    weight = (rs.rand(3, 17) > 0.3).astype(np.float32) if weighted else None
    size = (48, 64) if sized else None
    jhm = jnp.asarray(_nhwc(hm))
    jw = None if weight is None else jnp.asarray(weight)
    for port_fn, jax_fn in ((optional.integral_l1_loss,
                             jax_optional.integral_l1_loss),
                            (optional.structure_cosine_loss,
                             jax_optional.structure_cosine_loss)):
        got = port_fn(hm, torch.from_numpy(joints),
                      None if weight is None else torch.from_numpy(weight),
                      image_size=size)
        ref = jax_fn(jhm, jnp.asarray(joints), jw, image_size=size)
        np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)


def test_losses_are_differentiable_in_the_heatmaps():
    hm = torch.rand(1, 17, 8, 8, requires_grad=True)
    joints = torch.rand(1, 17, 2) * 32
    loss = (optional.integral_l1_loss(hm, joints, image_size=(32, 32))
            + optional.structure_cosine_loss(hm, joints, image_size=(32, 32)))
    loss.backward()
    assert torch.isfinite(hm.grad).all() and hm.grad.abs().sum() > 0


# -- offset targets -------------------------------------------------------------------

@pytest.mark.parametrize("radius,per_pixel", [(4, True), (2, False), (0, True)])
def test_offset_targets_match_jax(radius, per_pixel):
    rs = np.random.RandomState(2)
    ja = (rs.rand(2, 5, 2) * [20, 16]).astype(np.float32)
    ja[0, 0] = [4.0, 4.0]  # on the grid: the radius' edges are exact
    jb = (ja + rs.randn(2, 5, 2) * 3).astype(np.float32)
    vis = (rs.rand(2, 5) > 0.3).astype(np.float32)
    off, w = generate_offset_targets(torch.from_numpy(ja), torch.from_numpy(jb),
                                     torch.from_numpy(vis), (20, 16),
                                     radius=radius, per_pixel=per_pixel)
    ref_off, ref_w = jax_offset_targets(jnp.asarray(ja), jnp.asarray(jb),
                                        jnp.asarray(vis), output_size=(20, 16),
                                        radius=radius, per_pixel=per_pixel)
    assert off.shape == (2, 5, 2, 16, 20) and w.shape == (2, 5, 16, 20)
    np.testing.assert_array_equal(w.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(ref_w))
    np.testing.assert_allclose(off.numpy().transpose(0, 3, 4, 1, 2),
                               np.asarray(ref_off), rtol=RTOL, atol=0)
    assert w.sum() > 0


# -- integral-regression decode ---------------------------------------------------

def test_final_preds_coord_matches_jax():
    rs = np.random.RandomState(3)
    kp = np.concatenate([rs.rand(4, 17, 2) - 0.5, rs.rand(4, 17, 1)],
                        axis=2).astype(np.float32)
    center = (rs.rand(4, 2) * 300 + 50).astype(np.float32)
    scale = (rs.rand(4, 2) + 0.5).astype(np.float32)
    preds, maxvals = get_final_preds_coord(torch.from_numpy(kp), center, scale,
                                           (48, 64))
    ref_p, ref_m = jax_coord(jnp.asarray(kp), jnp.asarray(center),
                             jnp.asarray(scale), (48, 64))
    np.testing.assert_allclose(preds.numpy(), np.asarray(ref_p), rtol=RTOL)
    np.testing.assert_array_equal(maxvals.numpy(), np.asarray(ref_m))


# -- initializers -----------------------------------------------------------------

CONV = (64, 32, 7, 7)     # torch OIHW; flax HWIO (7, 7, 32, 64)
LINEAR = (392, 256)       # torch (out, in); flax (256, 392)


def _flax_shape(shape):
    return tuple(shape[2:]) + (shape[1], shape[0]) if len(shape) == 4 \
        else (shape[1], shape[0])


def _expected(name, shape):
    """(mean, std, low, high) of the distribution a name draws for a layer
    of ``shape`` (torch's), from flax's definitions; bounds None where the
    support is unbounded."""
    receptive = math.prod(shape[2:])
    fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    if name == "kaiming":
        lim = math.sqrt(3 * (1 / 3) / fan_in)
        return 0.0, lim / math.sqrt(3), -lim, lim
    if name == "xavier":
        lim = math.sqrt(3 * 2 / (fan_in + fan_out))
        return 0.0, lim / math.sqrt(3), -lim, lim
    if name in ("kaiming_normal", "xavier_normal", "lecun"):
        var = {"kaiming_normal": 2 / fan_in, "lecun": 1 / fan_in,
               "xavier_normal": 2 / (fan_in + fan_out)}[name]
        bound = 2 * math.sqrt(var) / TRUNCATED_STD
        return 0.0, math.sqrt(var), -bound, bound
    if name == "normal":
        return 0.0, 0.02, None, None
    if name == "uniform":
        return 0.15, 0.3 / math.sqrt(12), 0.0, 0.3
    raise KeyError(name)


def _check_samples(a, mean, std, low, high, what):
    a = np.asarray(a, np.float64).reshape(-1)
    n = a.size
    assert n >= 100_000
    assert abs(a.mean() - mean) <= 4 * std / math.sqrt(n), (what, a.mean())
    assert abs(a.std() / std - 1) <= 0.02, (what, a.std(), std)
    if low is not None:
        # within the support, and reaching its ends (1% of the width)
        assert low <= a.min() and a.max() <= high, what
        assert a.min() - low <= 0.01 * (high - low), what
        assert high - a.max() <= 0.01 * (high - low), what


@pytest.mark.parametrize("shape", [CONV, LINEAR], ids=["conv", "linear"])
@pytest.mark.parametrize("name", ["kaiming", "kaiming_normal", "xavier",
                                  "xavier_normal", "lecun", "normal",
                                  "uniform"])
def test_initializers_draw_flax_distributions(name, shape):
    kw = {"std": 0.02, "scale": 0.3}
    mean, std, low, high = _expected(name, shape)
    t = torch.empty(shape)
    out = get_initializer(name, **kw)(t, generator=torch.Generator()
                                      .manual_seed(0))
    assert out is t
    _check_samples(t.numpy(), mean, std, low, high, ("port", name))
    ref = jax_initializer(name, **kw)(jax.random.PRNGKey(0),
                                      _flax_shape(shape), jnp.float32)
    _check_samples(np.asarray(ref), mean, std, low, high, ("flax", name))


def test_raw_sigma_truncation_is_not_flax():
    """Truncating at +-2 of the raw sigma, as ``trunc_normal_(std=sigma)``
    alone does, narrows the spread to 0.88 of flax's: the 2% bound sees
    it."""
    mean, std, _, _ = _expected("kaiming_normal", CONV)
    t = torch.nn.init.trunc_normal_(torch.empty(CONV), 0.0, std, -2 * std,
                                    2 * std)
    with pytest.raises(AssertionError):
        _check_samples(t.numpy(), mean, std, None, None, "raw sigma")


def test_constant_and_unknown_initializers():
    t = get_initializer("constant", value=1.5)(torch.empty(3, 4))
    assert torch.equal(t, torch.full((3, 4), 1.5))
    ref = jax_initializer("constant", value=1.5)(jax.random.PRNGKey(0), (4, 3))
    assert np.array_equal(np.asarray(ref), np.full((4, 3), 1.5, np.float32))
    for aliases in (("kaiming", "kaiming_uniform", "he", "KAIMING"),
                    ("xavier", "glorot")):
        t = [get_initializer(a)(torch.empty(8, 8),
                                generator=torch.Generator().manual_seed(1))
             for a in aliases]
        assert all(torch.equal(t[0], u) for u in t)
    with pytest.raises(KeyError, match="bogus"):
        get_initializer("bogus")
    with pytest.raises(ValueError, match=">= 2 dims"):
        get_initializer("lecun")(torch.empty(5))


# -- IO and logging helpers ------------------------------------------------------------

def test_io_helpers_match_jax(tmp_path):
    obj = {"a": [1, 2.5, "x"], "b": {"c": None}}
    for sub, mod in (("port", io_utils), ("jax", jax_io)):
        path = str(tmp_path / sub / "deep" / "o.json")
        mod.write_json_to_file(obj, path)
        assert mod.read_json_from_file(path) == obj
        mod.create_folder(str(tmp_path / sub / "f"))
        for name in ("f10.jpg", "f2.jpg", "F1.png", "g.txt"):
            open(str(tmp_path / sub / "f" / name), "w").close()
    with open(tmp_path / "port" / "deep" / "o.json", "rb") as f, \
            open(tmp_path / "jax" / "deep" / "o.json", "rb") as g:
        assert f.read() == g.read()
    folder = str(tmp_path / "port" / "f")
    for ext in (None, ".jpg", (".jpg", ".png")):
        assert io_utils.list_immediate_childfile_paths(folder, ext) == \
            jax_io.list_immediate_childfile_paths(folder, ext)
    names = ["f10", "f2", "F1", "a100b3", "a100b20", "x"]
    assert io_utils.natural_sort(names) == jax_io.natural_sort(names) == [
        "a100b3", "a100b20", "F1", "f2", "f10", "x"]
    img = np.random.RandomState(4).randint(0, 256, (6, 7, 3)).astype(np.uint8)
    io_utils.save_image(str(tmp_path / "port" / "i" / "a.png"), img)
    jax_io.save_image(str(tmp_path / "jax" / "i" / "a.png"), img)
    got = io_utils.read_image(str(tmp_path / "port" / "i" / "a.png"))
    assert np.array_equal(got, img)
    assert np.array_equal(got, jax_io.read_image(str(tmp_path / "jax" / "i"
                                                     / "a.png")))
    with pytest.raises(IOError, match="Fail to read"):
        io_utils.read_image(str(tmp_path / "none.png"))


def test_logging_helpers_match_jax(tmp_path):
    root = logging.getLogger()
    saved = (list(root.handlers), root.level)
    try:
        for sub, mod in (("port", logging_utils), ("jax", jax_logging)):
            path = mod.phase_log_file(str(tmp_path / sub / "log"), "train")
            assert re.fullmatch(
                re.escape(str(tmp_path / sub / "log")) +
                r"/train-\d{4}-\d\d-\d\d-\d\d-\d\d\.log", path)
            got = mod.reset_logger(path, level=logging.DEBUG)
            assert got is root and root.level == logging.DEBUG
            assert [type(h) for h in root.handlers] == [
                logging.StreamHandler, logging.FileHandler]
            logging.getLogger("probe").info("hello %s", sub)
            for h in root.handlers:
                h.flush()
            with open(path) as f:
                assert re.search(rf"INFO probe: hello {sub}$", f.read(), re.M)
            for h in list(root.handlers):
                h.close()
                root.removeHandler(h)
        assert logging_utils.reset_logger(None).handlers[0].stream \
            is not None and len(root.handlers) == 1
        assert logging_utils.create_folder(str(tmp_path / "c")) == \
            str(tmp_path / "c") and osp.isdir(tmp_path / "c")
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
        for h in saved[0]:
            root.addHandler(h)
        root.setLevel(saved[1])


# -- python -m fami_pose_torch.tools.convert_poseval ------------------------------

def test_convert_poseval_tool_matches_jax(tmp_path, capsys):
    src = tmp_path / "old"
    src.mkdir()
    with open(src / "000043_mpii_train.json", "w") as f:
        json.dump(_annolist_fixture(), f)
    written = convert_poseval.main([str(src), "--out_fp",
                                    str(tmp_path / "new")])
    assert "wrote 1 file(s)" in capsys.readouterr().out
    ref = jax_convert_dir(str(src), str(tmp_path / "ref"))
    assert [osp.basename(p) for p in written] == [osp.basename(p)
                                                 for p in ref]
    for a, b in zip(written, ref):
        with open(a) as f, open(b) as g:
            assert json.load(f) == json.load(g)
    # and back, from a single file
    back = convert_poseval.main([written[0], "--out_fp",
                                 str(tmp_path / "back")])
    with open(back[0]) as f:
        assert len(json.load(f)["annolist"]) == 2
    assert os.listdir(tmp_path / "back") == ["000043_mpii_train.json"]
