"""The int8 serving path (``TPU.INT8_EVAL``) of the port against the JAX
package's (``fami_pose_tpu/models/quant.py``), on the CPU.

Tolerances, each with its reason:
  * one int8 conv (3x3 stride 1 and 2, 1x1, C_in = 3; with and without
    bias; f32 and bf16 activations) against ``QuantConv`` in mode ``int8``
    on the same x, W and scale: bit for bit. Both quantize with one f32
    multiply by the f32 reciprocal and round half to even, sum exactly in
    integers and dequant in the same f32 order.
  * the card route's plain versions (the int8 channels-last copy, the
    packed weight, the implicit GEMM with its dequant) against the plain
    conv and against ``QuantConv``: bit for bit (integer sums are exact in
    any order, so K in (ky, kx, c) order changes no bit).
  * ``quant_scales_from_stats``: bit for bit, margins 1, 2 and 1.3, absmax 0.
  * the calibrated scales of a whole model: relative 1e-5 (the absmaxes
    come from float activations that XLA and torch's CPU kernels sum in
    other orders).
  * whole-model int8 heatmaps with the JAX scales carried across: within a
    tenth of JAX's own int8-vs-f32 gap on the same inputs in f32 (a
    BatchNorm ulp can move a value across a rounding boundary of the next
    conv's quantizer), and in bf16 within 1.5 times JAX's own bf16-vs-f32
    gap of the int8 model, as ``tests/test_torch_bf16_parity.py`` holds the
    float path.
"""

import json
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fami_pose_tpu.config import get_default_cfg as jax_default_cfg
from fami_pose_tpu.models import hrnet as jax_hrnet
from fami_pose_tpu.models.fami_pose import FAMIPose as JaxFAMIPose
from fami_pose_tpu.models.quant import (
    QuantConv, calibrate as jax_calibrate,
    quant_scales_from_stats as jax_scales_from_stats,
)
from fami_pose_torch.config import get_cfg
from fami_pose_torch.models.bridge import (
    quant_scales_from_flax, state_dict_from_flax,
)
from fami_pose_torch.models.fami_pose import FAMIPose
from fami_pose_torch.models.hrnet import HRNet, TINY_EXTRA
from fami_pose_torch.models.layers import Conv2d
from fami_pose_torch.models.quant import (
    calibrate, quant_scales, quant_scales_from_stats, quantized_convs,
    set_quant_scales,
)
from fami_pose_torch.ops import int8_conv
from fami_pose_torch.utils.registry import TEST_PHASE, TRAIN_PHASE, VAL_PHASE
from torch_port_helpers import nchw, nhwc, random_variables

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
SERVING_YAML = osp.join(ROOT, "configs", "posetrack18", "fami_pose_serving.yaml")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# (C_in, C_out, kernel, stride): the branch 3x3, a strided 3x3, a 1x1, and
# the stem's C_in = 3 (K = 27, padded to 32 on the card)
CONVS = {"3x3s1": (8, 16, 3, 1), "3x3s2": (8, 16, 3, 2), "1x1": (16, 8, 1, 1),
         "cin3": (3, 16, 3, 2)}
# (C_in, C_out, kernel, stride, dilation) of the card route's decomposition:
# the branch 3x3, a strided 3x3, a 1x1, the stem (C_in 3 -> Cp 16), a ragged
# 1x1 (C_in 40 -> Cp 48, N 24 -> Np 32; 2 * 11 * 9 = 198 rows, not a
# multiple of the kernel's 64), N 384 and dilation 3
ROUTE_CASES = {"3x3s1": (8, 16, 3, 1, 1), "3x3s2": (8, 16, 3, 2, 1),
               "1x1": (16, 8, 1, 1, 1), "stem": (3, 64, 3, 2, 1),
               "ragged": (40, 24, 1, 1, 1), "n384": (16, 384, 3, 1, 1),
               "dilated": (8, 16, 3, 1, 3)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _conv_case(name, seed=0):
    return _random_conv(*CONVS[name], seed=seed)


def _random_conv(cin, cout, k, s, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(2, 11, 9, cin) * 1.7).astype(np.float32)
    w = (rs.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(np.float32)
    b = (0.1 * rs.randn(cout)).astype(np.float32)
    # a margin below 1 clips the largest inputs: the clamp is exercised
    scale = np.asarray(jax_scales_from_stats(
        {"act_absmax": np.abs(x).max()}, margin=0.8)["act_scale"])
    return x, w, b, scale, k, s


def _quant_conv_ref(case, bias, dtype):
    """JAX ``QuantConv`` in mode int8 on case ``case``: (numpy f32 output,
    the case's inputs)."""
    x, w, b, scale, k, s = _conv_case(case)
    jdt = DTYPES[dtype][0]
    p = (k - 1) // 2
    qc = QuantConv(w.shape[-1], (k, k), strides=(s, s),
                   padding=((p, p), (p, p)), use_bias=bias, dtype=jdt,
                   quant="int8")
    params = {"kernel": w, **({"bias": b} if bias else {})}
    ref = qc.apply({"params": params, "quant": {"act_scale": scale}},
                   jnp.asarray(x).astype(jdt))
    return np.asarray(ref, np.float32), (x, w, b, scale, k, s)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("case", list(CONVS))
def test_int8_conv_matches_quant_conv_bitwise(case, bias, dtype):
    ref, (x, w, b, scale, k, s) = _quant_conv_ref(case, bias, dtype)
    tdt = DTYPES[dtype][1]
    p = (k - 1) // 2
    conv = Conv2d(w.shape[2], w.shape[3], k, stride=s, padding=p, bias=bias,
                  quant="int8")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        if bias:
            conv.bias.copy_(torch.from_numpy(b))
    conv.set_act_scale(scale, case)
    with torch.no_grad():
        got = conv(nchw(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(nhwc(got), ref)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CONVS))
def test_card_route_plain_versions_match_quant_conv_bitwise(case, dtype):
    """quant_nhwc_plain, pack_weight and implicit_gemm_plain (with a bias)
    on JAX's inputs give QuantConv's bits."""
    ref, (x, w, b, scale, k, s) = _quant_conv_ref(case, True, dtype)
    wq, w_scale = int8_conv.quantize_weight(
        torch.from_numpy(w.transpose(3, 2, 0, 1)))
    act = torch.tensor(scale)
    xq = int8_conv.quant_nhwc_plain(nchw(x).to(DTYPES[dtype][1]), act)
    got = int8_conv.implicit_gemm_plain(
        xq, int8_conv.pack_weight(wq, x.shape[-1], k), w_scale, act,
        torch.from_numpy(b), k, s, (k - 1) // 2,
        out_dtype=DTYPES[dtype][1])
    np.testing.assert_array_equal(nhwc(got), ref)


def test_quantizer_rounds_half_to_even_and_clips():
    """Values on the half-way points and past +-127 scales, against JAX's
    formula on the same values."""
    scale = np.float32(0.5)
    x = np.array([0.25, 0.75, 1.25, -0.25, -0.75, -1.25, 63.25, 63.75, 70.0,
                  -70.0, 0.0], np.float32)
    want = np.clip(np.round(x * (np.float32(1.0) / scale)), -127, 127)
    got = int8_conv.quantize_plain(torch.from_numpy(x), torch.tensor(scale))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), [0, 2, 2, 0, -2, -2, 126, 127, 127, -127, 0])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_card_route_decomposition_is_the_plain_conv(case, bias, dtype):
    """quant_nhwc_plain (Cp a multiple of 16, the padded channels zero), the
    packed weight, the plain implicit GEMM and its dequant give the plain
    conv's bits: K in (ky, kx, c) order sums the same integers."""
    cin, cout, k, s, d = ROUTE_CASES[case]
    x, w, b, scale, _, _ = _random_conv(cin, cout, k, s, seed=1)
    tdt = DTYPES[dtype][1]
    wq, w_scale = int8_conv.quantize_weight(
        torch.from_numpy(w.transpose(3, 2, 0, 1)))
    act = torch.tensor(scale)
    xt = nchw(x).to(tdt)
    bias_t = torch.from_numpy(b) if bias else None
    kw = dict(kernel_size=k, stride=s, padding=d * (k - 1) // 2, dilation=d)
    xq = int8_conv.quant_nhwc_plain(xt, act)
    cp = xq.shape[3]
    assert xq.dtype == torch.int8 and cp % 16 == 0 and 0 <= cp - cin < 16
    assert not xq[..., cin:].any()
    assert torch.equal(xq[..., :cin].permute(0, 3, 1, 2).float(),
                       int8_conv.quantize_plain(xt, act))
    got = int8_conv.implicit_gemm_plain(
        xq, int8_conv.pack_weight(wq, cin, k), w_scale, act, bias_t,
        out_dtype=tdt, **kw)
    ref = int8_conv.int8_conv2d_plain(xt, wq, w_scale, act, bias_t, **kw)
    assert got.dtype == tdt and got.shape == ref.shape
    assert torch.equal(got, ref)


# (C_in, C_out, kernel): the stem, the ragged 1x1 (N 24 -> 32), the 12x9
# branch's 384, layer1's 256, and 300 (-> 304)
PACK_CASES = [(3, 64, 3), (40, 24, 1), (48, 384, 3), (64, 256, 1),
              (16, 300, 3)]


@pytest.mark.parametrize("c,n,k", PACK_CASES)
def test_packed_weight_layout(c, n, k):
    """(Np, Kp) int8, K-major: each tap's Cp channels in (ky, kx, c) order,
    K zero-padded to a multiple of 32 (one s8 wgmma step), N to a multiple
    of 16; the padding zero."""
    rs = np.random.RandomState(3)
    wq, _ = int8_conv.quantize_weight(
        torch.from_numpy(rs.randn(n, c, k, k).astype(np.float32)))
    wp = int8_conv.pack_weight(wq, c, k)
    cp = -(-c // 16) * 16
    assert wp.dtype == torch.int8 and wp.is_contiguous()
    assert wp.shape == (-(-n // 16) * 16, -(-k * k * cp // 32) * 32)
    assert wp.shape == int8_conv.packed_shape(n, c, k)
    body = wp[:n, :k * k * cp].reshape(n, k, k, cp)
    assert torch.equal(body[..., :c],
                       wq.reshape(n, c, k, k).permute(0, 2, 3, 1))
    assert not body[..., c:].any()
    assert not wp[:n, k * k * cp:].any() and not wp[n:].any()


def test_packed_weight_is_a_buffer_outside_the_state_dict():
    conv = Conv2d(40, 24, 3, padding=1, bias=True, quant="int8")
    keys = list(conv.state_dict())
    assert conv.weight_packed is None
    conv.set_act_scale(0.05, "c")
    assert torch.equal(conv.weight_packed,
                       int8_conv.pack_weight(conv.weight_q, 40, 3))
    assert "weight_packed" in dict(conv.named_buffers())
    assert list(conv.state_dict()) == keys
    conv.load_state_dict(conv.state_dict())
    assert conv.weight_packed is None and conv.weight_q is None


def test_quantize_weight_matches_quant_conv():
    rs = np.random.RandomState(2)
    w = rs.randn(3, 3, 8, 16).astype(np.float32)
    w[..., 5] = 0.0  # a dead output channel: w_scale 1e-12 / 127, kq 0
    w_scale = jnp.maximum(jnp.max(jnp.abs(w), axis=(0, 1, 2)), 1e-12) * (
        1.0 / 127.0)
    kq = jnp.round(w * (1.0 / w_scale)).astype(jnp.int8)
    wq, ws = int8_conv.quantize_weight(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(w_scale))
    np.testing.assert_array_equal(
        wq[:, :72].numpy(), np.asarray(kq).transpose(3, 2, 0, 1).reshape(16, 72))


@pytest.mark.parametrize("margin", [1.0, 2.0, 1.3])
def test_quant_scales_from_stats_matches_jax(margin):
    rs = np.random.RandomState(4)
    values = list(rs.uniform(0, 50, 6).astype(np.float32)) + [np.float32(0)]
    jax_tree = jax_scales_from_stats(
        {f"c{i}": {"act_absmax": v} for i, v in enumerate(values)}, margin)
    port = quant_scales_from_stats(
        {f"c{i}": torch.tensor(v) for i, v in enumerate(values)}, margin)
    for i in range(len(values)):
        got = port[f"c{i}"]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_tree[f"c{i}"]["act_scale"]))
    assert float(port[f"c{len(values) - 1}"]) > 0  # a dead input


def _hrnet_port(variables, quant="off"):
    params = dict(variables["params"])
    tree = {"params": {"final_layer": params.pop("final_layer"),
                       "hrnet": params},
            "batch_stats": {"hrnet": variables["batch_stats"]}}
    sd = {k[len("hrnet."):]: v for k, v in state_dict_from_flax(tree).items()}
    port = HRNet(TINY_EXTRA, 17, quant=quant)
    port.load_state_dict(sd)
    return port.eval()


def _check_scales(port_scales, jax_quant, prefix=""):
    want = {k[len(prefix):]: v
            for k, v in quant_scales_from_flax(jax_quant).items()}
    assert set(port_scales) == set(want)
    for name, v in want.items():
        np.testing.assert_allclose(port_scales[name].numpy(), v.numpy(),
                                   rtol=1e-5, err_msg=name)
    return want


def test_hrnet_int8_calibration_and_heatmaps_match_jax():
    rs = np.random.RandomState(5)
    x = rs.rand(2, 64, 64, 3).astype(np.float32)
    jm = jax_hrnet.HRNet(extra=jax_hrnet.TINY_EXTRA, num_joints=17)
    variables = random_variables(lambda k: jm.init(k, x[:1]), seed=5)
    quant = jax.jit(lambda v, a: jax_calibrate(
        jax_hrnet.HRNet(extra=jax_hrnet.TINY_EXTRA, num_joints=17,
                        quant="calibrate"), v, [(a,)]))(variables, x)
    jq = jax_hrnet.HRNet(extra=jax_hrnet.TINY_EXTRA, num_joints=17,
                         quant="int8")
    ref_int8 = np.asarray(jax.jit(jq.apply)({**variables, "quant": quant},
                                            x)[0])
    ref_f32 = np.asarray(jax.jit(jm.apply)(variables, x)[0])

    port = _hrnet_port(variables, "int8")
    scales = calibrate(port, [(nchw(x),)])
    assert "final_layer" not in scales and len(scales) == 49
    jax_scales = _check_scales(scales, {"hrnet": quant}, prefix="hrnet.")
    set_quant_scales(port, jax_scales)
    with torch.no_grad():
        got = nhwc(port(nchw(x))[0])
    gap = np.abs(ref_int8 - ref_f32).max()
    assert gap > 0
    assert np.abs(got - ref_int8).max() <= 0.1 * gap


JAX_KW = dict(extra=TINY_EXTRA, num_joints=17, feat_channels=8,
              dcn_offset_groups=4, dcn_max_offset=2)


@pytest.fixture(scope="module")
def fami():
    """JAX FAMIPose variables, its calibration and heatmaps (f32 float,
    f32 int8, bf16 int8) on one seeded batch."""
    m = JaxFAMIPose(**JAX_KW)
    variables = random_variables(
        lambda k: m.init(k, jnp.zeros((1, 64, 64, 3)),
                         jnp.zeros((1, 64, 64, 12)), train=False), seed=7)
    # the head's DCN kernels at 0.3 of their draw keep the random-weight
    # heatmaps O(10) (tests/test_torch_evaluator.py does the same)
    for i in range(1, 5):
        variables["params"][f"dcn_{i}"]["kernel"] *= np.float32(0.3)
    rs = np.random.RandomState(3)
    kf = rs.randn(2, 64, 64, 3).astype(np.float32)
    sup = rs.randn(2, 64, 64, 12).astype(np.float32)

    def run(dtype, quant, v):
        model = JaxFAMIPose(**JAX_KW, dtype=dtype, backbone_quant=quant)
        out = jax.jit(lambda vv, a, s: model.apply(vv, a, s, train=False))(
            v, kf, sup)
        return [np.asarray(t, np.float32) for t in out]

    quant = jax.jit(lambda v, a, s: jax_calibrate(
        JaxFAMIPose(**JAX_KW, backbone_quant="calibrate"), v, [(a, s)],
        train=False))(variables, kf, sup)
    with_q = {**variables, "quant": quant}
    return dict(variables=variables, quant=quant, kf=kf, sup=sup,
                f32=run(jnp.float32, "off", variables),
                int8=run(jnp.float32, "int8", with_q),
                int8_bf16=run(jnp.bfloat16, "int8", with_q))


def _port_fami(variables, dtype=torch.float32):
    m = FAMIPose(extra=TINY_EXTRA, num_joints=17, num_sup=4, feat_channels=8,
                 feat_hw=(16, 16), dcn_offset_groups=4, dcn_max_offset=2,
                 warp_max_shift=26, compute_dtype=dtype, backbone_quant="int8")
    m.load_state_dict(state_dict_from_flax(variables))
    return m.eval()


def test_fami_pose_calibration_matches_jax(fami):
    port = _port_fami(fami["variables"])
    scales = calibrate(port, [(nchw(fami["kf"]), nchw(fami["sup"]))])
    _check_scales(scales, fami["quant"])
    # the backbone less final_layer, and of the head only the residual
    # chains the JAX model gives the backbone's mode
    heads = {n.split(".")[0] for n in scales}
    assert heads == {"hrnet", "sup_agg_block", "combined_feat_layers",
                     "init_feature_agg_block"}
    assert len([n for n in scales if n.startswith("hrnet.")]) == 49
    assert not any(n.startswith(("hrnet.final_layer", "feat_global_offset",
                                 "dcn_", "agg_final_layer")) for n in scales)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fami_pose_int8_heatmaps_match_jax(fami, dtype):
    tdt = DTYPES[dtype][1]
    port = _port_fami(fami["variables"], tdt)
    set_quant_scales(port, quant_scales_from_flax(fami["quant"]))
    with torch.no_grad():
        got = [nhwc(t) for t in port(nchw(fami["kf"]), nchw(fami["sup"]))]
    for i, name in enumerate(("final_hm", "kf_bb_hm")):
        if dtype == "f32":
            ref = fami["int8"][i]
            tol = 0.1 * np.abs(fami["int8"][i] - fami["f32"][i]).max()
        else:
            ref = fami["int8_bf16"][i]
            tol = 1.5 * np.abs(fami["int8_bf16"][i] - fami["int8"][i]).max()
        assert tol > 0, name
        assert np.abs(got[i] - ref).max() <= tol, name


def test_from_config_gates_int8_to_eval_phases_as_jax():
    from fami_pose_tpu.models.fami_pose import FAMIPose as JaxModel

    for int8 in (True, False):
        jcfg = jax_default_cfg()
        jcfg.TPU.INT8_EVAL = int8
        cfg = get_cfg()
        cfg.TPU.INT8_EVAL = int8
        cfg.MODEL.EXTRA = TINY_EXTRA
        for phase in (TRAIN_PHASE, VAL_PHASE, TEST_PHASE):
            want = JaxModel.from_config(jcfg, phase=phase).backbone_quant
            got = FAMIPose.from_config(cfg, phase=phase)
            assert got.backbone_quant == want == (
                "int8" if int8 and phase != TRAIN_PHASE else "off")
            assert bool(quantized_convs(got)) == (want == "int8")
        assert FAMIPose.from_config(cfg).backbone_quant == "off"  # train


def test_state_dict_is_unchanged_by_calibration(fami):
    port = _port_fami(fami["variables"])
    before = {k: v.clone() for k, v in port.state_dict().items()}
    calibrate(port, [(nchw(fami["kf"]), nchw(fami["sup"]))])
    after = port.state_dict()
    assert list(after) == list(before)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    # and a float model's state_dict has the same keys
    plain = FAMIPose(extra=TINY_EXTRA, num_joints=17, num_sup=4,
                     feat_channels=8, feat_hw=(16, 16), dcn_offset_groups=4)
    assert list(plain.state_dict()) == list(after)


def test_int8_forward_without_scales_raises(fami):
    port = _port_fami(fami["variables"])
    args = (nchw(fami["kf"]), nchw(fami["sup"]))
    with pytest.raises(RuntimeError, match="no activation scale"):
        port(*args)
    calibrate(port, [args])
    assert all(s is not None for s in quant_scales(port).values())
    # loading a state_dict clears the scales: no checkpoint is served with
    # another's
    port.load_state_dict(port.state_dict())
    assert all(s is None for s in quant_scales(port).values())
    with pytest.raises(RuntimeError, match="no activation scale"):
        port(*args)
    with pytest.raises(KeyError, match="missing"):
        set_quant_scales(port, {})


def test_serving_yaml_merges_in_the_port_with_the_levers_on():
    cfg = get_cfg()
    cfg.merge_from_file(SERVING_YAML)
    assert cfg.TPU.INT8_EVAL is True and cfg.TPU.DCN_AUTO_WINDOW is True
    assert int(cfg.TPU.INT8_CALIB_BATCHES) == 2
    assert cfg.VAL.FLIP_VAL is True and cfg.TEST.FLIP_TEST is True
    assert cfg.DATASET.IS_POSETRACK18 is True
    assert cfg.EXPERIMENT_NAME == "fami_pose_pt18_serving"
    assert FAMIPose.from_config(cfg, phase=VAL_PHASE).backbone_quant == "int8"


def test_predictor_and_demo_refuse_int8(tmp_path):
    import cv2

    from fami_pose_torch import demo
    from fami_pose_torch.engine.predictor import PosePredictor, serving_model

    cfg = get_cfg()
    cfg.merge_from_file(SERVING_YAML)
    with pytest.raises(NotImplementedError, match="TPU.INT8_EVAL"):
        serving_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="TPU.INT8_EVAL"):
        PosePredictor(cfg, device="cpu")
    frames = tmp_path / "frames"
    frames.mkdir()
    cv2.imwrite(str(frames / "000.jpg"), np.zeros((48, 64, 3), np.uint8))
    for extra in ([], ["--streaming"]):
        with pytest.raises(NotImplementedError, match="TPU.INT8_EVAL"):
            demo.main(["--cfg", SERVING_YAML, "--frames", str(frames),
                       "--device", "cpu", "--out", str(tmp_path / "out"),
                       *extra])
    assert not (tmp_path / "out").exists()


def test_int8_numerics_tool_runs_on_the_cpu(capsys):
    from fami_pose_torch.tools import int8_numerics

    assert int8_numerics.main(["--batch", "1", "--image-size", "32", "32",
                               "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rep = json.loads(lines[0])
    assert rep["device"] == "cpu" and rep["int8_convs"] == 307
    for head in ("final", "backbone"):
        assert set(rep["pairs"][head]) == {"bf16 vs f32", "int8 vs bf16",
                                           "int8 vs f32"}
        for row in rep["pairs"][head].values():
            assert all(np.isfinite(v) for v in row.values())
            assert 0.0 <= row["argmax_agree"] <= 1.0


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    x = torch.randn(2, 3, 9, 7)
    act = torch.tensor(0.02)
    wq, ws = int8_conv.quantize_weight(torch.randn(8, 3, 3, 3))
    wp = int8_conv.pack_weight(wq, 3, 3)
    counters = (int8_conv.quant_nhwc, int8_conv.implicit_gemm)
    before = [fn.launches for fn in counters]
    xq = int8_conv.quant_nhwc(x, act)
    assert torch.equal(xq, int8_conv.quant_nhwc_plain(x, act))
    y = int8_conv.implicit_gemm(xq, wp, ws, act, None, 3, 1, 1)
    assert torch.equal(y, int8_conv.implicit_gemm_plain(xq, wp, ws, act, None,
                                                        3, 1, 1))
    assert [fn.launches for fn in counters] == before  # no kernel ran
    meta = torch.empty(2, 3, 9, 7, device="meta")
    with pytest.raises(ValueError, match="no int8 conv kernel"):
        int8_conv.quant_nhwc(meta, act)
    with pytest.raises(ValueError, match="no int8 conv kernel"):
        int8_conv.implicit_gemm(xq.to("meta"), wp, ws, act, None, 3, 1, 1)
    with pytest.raises(ValueError, match="no int8 conv kernel"):
        int8_conv.int8_conv2d(meta, wq, ws, act, None, 3, padding=1)


def _wide_weight(c):
    """A 3x3 weight with C inputs, quantized and packed."""
    wq, _ = int8_conv.quantize_weight(torch.randn(32, c, 3, 3))
    return wq, int8_conv.pack_weight(wq, c, 3)


@pytest.mark.parametrize("fault", ["wq", "w_packed", "no_w_packed", "pixels",
                                   "k"])
def test_int8_conv_conditions_name_the_conv(fault):
    """What the card route refuses (checked before any launch) raises a
    ValueError that names the conv."""
    wq, _ = int8_conv.quantize_weight(torch.randn(64, 3, 3, 3))
    wp = int8_conv.pack_weight(wq, 3, 3)
    shape, geo = (2, 3, 37, 29), (3, 2, 1, 1)
    int8_conv.check_conv(shape, wq, wp, *geo, "hrnet.conv1")
    bad = {"wq": (shape, wq[:, :26], wp),
           "w_packed": (shape, wq, wp[:, :144]),
           "no_w_packed": (shape, wq, None),
           "pixels": ((2 ** 16, 3, 2 ** 8, 2 ** 8), wq, wp),
           "k": ((2, 512, 37, 29), *_wide_weight(512))}[fault]
    with pytest.raises(ValueError, match="hrnet.conv1"):
        int8_conv.check_conv(*bad, *geo, "hrnet.conv1")
