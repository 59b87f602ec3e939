"""The plain versions of the port's on-chip gather and rotate probes
(``fami_pose_torch/ops/probes.py``) against the functions the TPU probes of
``tools/mosaic_watch.py`` compute (``jnp.take_along_axis``, ``jnp.roll``),
at the probes' shapes and types. The Pallas probes themselves pin
``memory_space=pltpu.VMEM`` and take no ``interpret`` flag, so they are held
through their plain reference. Every result is a copy of input values:
the comparison is bitwise. The CUDA kernels are held against these plain
versions on the card (``tests/test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fami_pose_torch.ops import probes
from fami_pose_torch.tools import hopper_watch


def _numpy_inputs(name, seed):
    """Seeded numpy inputs at the TPU probe's shape; bf16 values are made
    exactly representable so that both frameworks hold the same bits."""
    shape, dtype = probes.PROBE_SHAPES[name]
    rs = np.random.RandomState(seed)
    x = rs.rand(*shape).astype(np.float32)
    if dtype == torch.bfloat16:
        x = torch.from_numpy(x).bfloat16().float().numpy()
    high = shape[0] if name == "gather_rows" else shape[-1]
    idx = rs.randint(0, high, shape).astype(np.int32)
    return x, idx, dtype


def _bits(t):
    return t.float().numpy()


@pytest.mark.parametrize("name,axis", [
    ("gather_lane", 1), ("gather_3d", 2), ("gather_rows", 0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_gather_plain_matches_take_along_axis(name, axis, seed):
    x, idx, dtype = _numpy_inputs(name, seed)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jnp.take_along_axis(jnp.asarray(x, jdtype), jnp.asarray(idx),
                              axis=axis)
    fn = getattr(probes, name)
    got = fn(torch.from_numpy(x).to(dtype), torch.from_numpy(idx))
    assert got.dtype == dtype and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(_bits(got),
                                  np.asarray(ref.astype(jnp.float32)))
    # the wrapper ran its plain version: no launch was counted on the CPU
    assert fn.launches == 0


@pytest.mark.parametrize("shift", [0, 5, 127, 128, -3])
def test_dynamic_roll_plain_matches_jnp_roll(shift):
    x, _, _ = _numpy_inputs("dynamic_roll", 2)
    ref = jnp.roll(jnp.asarray(x), shift, axis=1)
    got = probes.dynamic_roll(torch.from_numpy(x),
                              torch.tensor([shift], dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # out[:, j] = x[:, (j - s) mod 128]
    j = np.arange(128)
    np.testing.assert_array_equal(got.numpy(), x[:, (j - shift) % 128])
    assert probes.dynamic_roll.launches == 0


@pytest.mark.parametrize("name", sorted(probes.PROBE_SHAPES))
def test_probe_inputs_have_the_tpu_probes_shapes(name):
    shape, dtype = probes.PROBE_SHAPES[name]
    x, other = probes.probe_inputs(name, seed=3)
    assert tuple(x.shape) == shape and x.dtype == dtype
    assert other.dtype == torch.int32
    if name == "dynamic_roll":
        assert tuple(other.shape) == (1,) and int(other) == 5
    else:
        high = shape[0] if name == "gather_rows" else shape[-1]
        assert tuple(other.shape) == shape
        assert 0 <= int(other.min()) and int(other.max()) < high
    a, b = probes.probe_inputs(name, seed=3)
    assert torch.equal(a, x) and torch.equal(b, other)


def test_hopper_watch_on_cpu_tensors_reports_no_support(capsys):
    """Without a kernel launch no probe is ``SUPPORTED`` and the tool's exit
    code is non-zero."""
    assert hopper_watch.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert " SUPPORTED" not in out
    assert out.count("unsupported: no kernel was launched") == 5
    assert out.splitlines()[0].startswith("device: cpu")


def test_hopper_watch_without_a_card_exits_non_zero(capsys, monkeypatch):
    """The default device is the card; where there is none every probe is
    reported with its error and the exit code is non-zero."""
    if torch.cuda.is_available():
        monkeypatch.setattr(probes, "probe_inputs",
                            lambda *a, **k: (_ for _ in ()).throw(
                                RuntimeError("no device")))
    assert hopper_watch.main([]) == 1
    out = capsys.readouterr().out
    assert " SUPPORTED" not in out
    assert all(" unsupported: " in line for line in out.splitlines()[1:6])


def test_probe_failure_is_reported_and_fails_the_tool(capsys):
    """A wrong result is caught, printed as unsupported, and returned."""
    def wrong(x, idx):
        wrong.launches += 1
        return probes.gather_lane_plain(x, idx).roll(1, 0)

    wrong.launches = 0
    probes.PLAIN[wrong] = probes.gather_lane_plain
    try:
        ok = hopper_watch.probe(
            "bf16 lane gather", wrong,
            lambda: [probes.probe_inputs("gather_lane")])
    finally:
        del probes.PLAIN[wrong]
    assert ok is False
    assert "unsupported: result differs" in capsys.readouterr().out
