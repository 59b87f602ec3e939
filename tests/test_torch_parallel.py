"""Data parallelism in the port (``fami_pose_torch/parallel/mesh.py``)
against the JAX package's: the mesh arithmetic and its refusals,
``local_batch_slice`` and ``pad_to_multiple``; the process-sliced
``DataLoader`` against the JAX loader with the same ``process_index`` /
``process_count`` (the three unit tests of ``tests/test_multihost.py``);
the collective helpers and BatchNorm with global statistics in two gloo
processes (``tests/torch_dist.py``), the latter against flax's
``nn.BatchNorm`` on the whole batch; and a data axis of 1, which issues no
collective and is bit for bit the single-device step.

Tolerances. Loader batches, ``global_meta`` and the mesh arithmetic:
exact. Sync BatchNorm against flax (float32, 4 x 6 x 5 x 7 split 2 + 2,
statistics from sums over ranks against XLA's means): output, input
gradient and running statistics 2e-5 absolute, scale and bias gradients
(sums over the ranks) 1e-4 relative + 2e-5; the recomputed forward
(``REMAT_BACKBONE``'s ``torch.utils.checkpoint``) bit for bit equal to the
plain one in every rank.
"""

import os.path as osp

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from chip_smoke import SyntheticPoseDataset
from fami_pose_tpu.data.loader import DataLoader as JaxDataLoader
from fami_pose_tpu.data.posetrack import PoseTrackDataset as JaxPoseTrack
from fami_pose_tpu.parallel import mesh as jax_mesh
from fami_pose_torch.data.loader import DataLoader
from fami_pose_torch.data.posetrack import PoseTrackDataset
from fami_pose_torch.engine.steps import make_eval_step, make_train_step
from fami_pose_torch.engine.train_state import TrainState
from fami_pose_torch.engine.trainer import Trainer
from fami_pose_torch.models.fami_pose import FAMIPose
from fami_pose_torch.models.hrnet import TINY_EXTRA
from fami_pose_torch.models.layers import BatchNorm, sync_batch_norm
from fami_pose_torch.optim import build_optimizer
from fami_pose_torch.parallel import mesh as port_mesh
from fami_pose_torch.utils.registry import TRAIN_PHASE, VAL_PHASE
from fixtures import make_cfg, make_posetrack_fixture
from torch_dist import run_ranks
from torch_port_helpers import make_port_cfg


# -- the mesh's arithmetic ------------------------------------------------------------

@pytest.mark.parametrize("world,shape", [
    (1, [-1, 1]), (1, [1, 1]), (1, [-1]), (1, [1]), (1, None),
    (2, [-1, 1]), (2, [2]), (8, [-1, 1]), (8, [8]), (4, [4, 1]),
    (1, [2, 1]), (1, [8]), (1, [2, 2]), (1, [4]), (2, [4, 1]),
])
def test_build_mesh_matches_jax(world, shape):
    """Over ``world`` ranks (JAX: as many of the 8 virtual CPU devices) the
    port's mesh has the JAX mesh's shape, or both raise JAX's
    ``ValueError`` with its message."""
    devices = jax.devices()[:world]
    try:
        ref = jax_mesh.build_mesh(devices=devices, mesh_shape=shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_mesh.build_mesh(shape, world=world)
        assert str(got.value) == str(e)
        return
    got = port_mesh.build_mesh(shape, world=world, rank=0)
    assert got.shape == dict(ref.shape) and ref.size == world


@pytest.mark.parametrize("world,shape", [(1, [1, 4]), (4, [1, 4]),
                                         (4, [2, 2]), (8, [-1, 2])])
def test_model_axis_is_refused_by_name(world, shape):
    """JAX shards no layer on the ``model`` axis; the port replicates the
    work over it. Where the whole shape needs more devices than there are
    (one process, ``[1, 4]``), both raise JAX's ``ValueError``; elsewhere
    the port's mesh has JAX's shape, and rank r holds the data index of
    device r in JAX's mesh (its ``reshape`` of the device list)."""
    devices = jax.devices()[:world]
    try:
        ref = jax_mesh.build_mesh(devices=devices, mesh_shape=shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_mesh.build_mesh(shape, world=world)
        assert str(got.value) == str(e) and world == 1
        return
    for rank, device in enumerate(devices):
        got = port_mesh.build_mesh(shape, world=world, rank=rank)
        assert got.shape == dict(ref.shape) and got.size == world
        (data_index, model_index), = np.argwhere(ref.devices == device)
        assert got.data_index == data_index
        assert rank == data_index * got.model + model_index


@pytest.mark.parametrize("rank", range(4))
def test_a_two_by_two_mesh_slices_by_data_index(rank):
    """``[2, 2]`` over 4 ranks: ranks 0, 1 hold data index 0 and ranks 2, 3
    data index 1, each the contiguous half of a global batch of 8 that its
    data index owns (``local_batch_slice``, ``local_rows``), as JAX's
    ``P("data")`` sharding over ``reshape([2, 2])`` of 4 devices places
    it."""
    mesh = port_mesh.build_mesh([2, 2], world=4, rank=rank)
    assert (mesh.data, mesh.model, mesh.size) == (2, 2, 4)
    assert mesh.data_index == rank // 2
    ref = jax_mesh.build_mesh(devices=jax.devices()[:4], mesh_shape=[2, 2])
    sharding = jax_mesh.batch_sharding(ref)
    placed = sharding.devices_indices_map((8,))[jax.devices()[rank]]
    assert port_mesh.local_batch_slice(8, mesh) == placed[0]
    x = torch.arange(8)
    assert torch.equal(port_mesh.local_rows(x, mesh), x[placed[0]])
    with pytest.raises(ValueError, match="not divisible by 2"):
        port_mesh.local_batch_slice(7, mesh)


def test_a_data_axis_must_span_the_ranks():
    """A data axis smaller than the process group would leave ranks without
    a slice of the batch."""
    with pytest.raises(ValueError, match="leaves ranks out"):
        port_mesh.build_mesh([1, 1], world=2)


@pytest.mark.parametrize("n", [0, 1, 4, 7, 8, 9, 32])
def test_batch_slice_and_padding_match_jax(n):
    """One process: the whole batch, and JAX's rounding up."""
    if n:
        assert port_mesh.local_batch_slice(n) == jax_mesh.local_batch_slice(n)
    for k in (1, 2, 8):
        assert port_mesh.pad_to_multiple(n, k) == \
            jax_mesh.pad_to_multiple(n, k)


# -- the process-sliced loader ------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parallel_loader"))
    _, img_dir = make_posetrack_fixture(root, n_videos=2, n_frames=5,
                                        people_per_frame=2, seed=0)
    return root, img_dir


def _datasets(fixture_root, phase):
    """The port's and the JAX package's dataset on the fixture, without
    augmentation (as ``tests/test_multihost.py`` builds it)."""
    root, img_dir = fixture_root
    out = []
    for make, cls in ((make_port_cfg, PoseTrackDataset),
                      (make_cfg, JaxPoseTrack)):
        cfg = make(osp.join(root, "json"), img_dir)
        cfg.TRAIN.SCALE_FACTOR = [0.0, 0.0]
        cfg.TRAIN.ROT_FACTOR = 0
        cfg.TRAIN.FLIP = False
        cfg.DATASET.RANDOM_AUX_FRAME = False
        out.append(cls(cfg, phase))
    return out


def _equal_batches(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k == "global_meta":
            _equal_batches(got[k], v)
        elif isinstance(v, list):
            assert list(got[k]) == list(v), k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=k)


def test_process_sliced_loader_matches_jax(fixture_root):
    """Train phase, shuffled, global batch 8 over 2 processes: each
    process's batches equal the JAX loader's of the same process, slices
    of one global order, with the same ``global_meta``."""
    port_ds, jax_ds = _datasets(fixture_root, TRAIN_PHASE)
    kw = dict(batch_size=8, shuffle=True, num_workers=1, drop_last=True,
              seed=7, process_count=2)
    full = list(DataLoader(port_ds, **dict(kw, process_count=1,
                                           process_index=0)))
    assert len(full) >= 2
    for p in range(2):
        loader = DataLoader(port_ds, process_index=p, **kw)
        assert loader.local_batch_size == 4 and len(loader) == len(full)
        batches = list(loader)
        refs = list(JaxDataLoader(jax_ds, process_index=p, **kw))
        assert len(batches) == len(refs) == len(full)
        for got, ref, whole in zip(batches, refs, full):
            _equal_batches(got, ref)
            rows = slice(4 * p, 4 * p + 4)
            np.testing.assert_array_equal(got["kf"], whole["kf"][rows])
            np.testing.assert_array_equal(got["center"],
                                          whole["center"][rows])
            assert got["global_meta"]["center"].shape == (8, 2)
            assert len(got["global_meta"]["image_path"]) == 8


def test_process_sliced_eval_meta_matches_the_samples(fixture_root):
    """Eval phase, padded last batch: the index-derived ``global_meta``
    equals the single-process loader's per-sample meta over the valid rows,
    and equals the JAX loader's."""
    port_ds, jax_ds = _datasets(fixture_root, VAL_PHASE)
    kw = dict(batch_size=8, shuffle=False, num_workers=1, drop_last=False)
    sliced = DataLoader(port_ds, process_index=0, process_count=2, **kw)
    full = DataLoader(port_ds, process_index=0, process_count=1, **kw)
    ref = JaxDataLoader(jax_ds, process_index=0, process_count=2, **kw)
    for bs, bf, br in zip(sliced, full, ref):
        _equal_batches(bs, br)
        valid = int(bf["valid"])
        meta = bs["global_meta"]
        for k in ("center", "scale", "score"):
            np.testing.assert_array_equal(meta[k][:valid], bf[k][:valid])
        assert meta["image_path"][:valid] == list(bf["image_path"][:valid])
        assert bs["valid"] == bf["valid"]


def test_process_sliced_loader_without_an_index():
    """A dataset without an index (``data``) is sliced the same way; its
    batches carry no ``global_meta`` (nothing global to read)."""
    data = SyntheticPoseDataset(12, (16, 24), 4, seed=3)
    kw = dict(batch_size=4, shuffle=True, num_workers=2, drop_last=True,
              seed=5)
    full = list(DataLoader(data, process_index=0, process_count=1, **kw))
    for p in range(2):
        batches = list(DataLoader(data, process_index=p, process_count=2,
                                  **kw))
        assert len(batches) == len(full) == 3
        for got, whole in zip(batches, full):
            assert "global_meta" not in got and got["valid"] == 4
            for k in ("kf", "sup", "joints", "joints_vis"):
                np.testing.assert_array_equal(got[k],
                                              whole[k][2 * p:2 * p + 2])


def test_indivisible_global_batch_is_refused_as_jax_does(fixture_root):
    port_ds, jax_ds = _datasets(fixture_root, TRAIN_PHASE)
    with pytest.raises(ValueError) as ref:
        JaxDataLoader(jax_ds, batch_size=9, process_index=0, process_count=2)
    with pytest.raises(ValueError, match="not divisible") as got:
        DataLoader(port_ds, batch_size=9, process_index=0, process_count=2)
    assert str(got.value) == str(ref.value)


# -- two gloo processes ---------------------------------------------------------------

def test_collectives_in_two_processes(tmp_path):
    """Each helper once on both ranks: the mean, the gathered rows in rank
    order, rank 0's broadcast values, the gradient of the differentiable
    sum (every rank's cotangent summed), each rank's slice of a global
    batch, the mesh over the group and its refusals."""
    r0, r1 = run_ranks("collectives", 2, tmp_path)
    for rank, r in enumerate((r0, r1)):
        assert torch.equal(r["mean"], torch.tensor([1.5, 3.0]))
        assert torch.equal(r["rows"], torch.tensor([[0.0] * 3] * 2
                                                   + [[1.0] * 3] * 2))
        assert torch.equal(r["bcast"], torch.tensor([5.0]))
        assert torch.equal(r["bcast_list"][0], torch.tensor([1.0, 2.0]))
        assert torch.equal(r["bcast_list"][1], torch.tensor(0.0))
        assert torch.equal(r["sum_grad"], torch.tensor([2.0, 7.0]))
        assert r["slice"] == slice(4 * rank, 4 * rank + 4)
        assert r["shard"]["n"] == 3 and r["shard"]["a"].shape == (2, 3)
        assert r["refused"] == {"[4]": "ValueError", "[1, 1]": "ValueError",
                                "[8, 1]": "ValueError"}
        assert all(m == port_mesh.Mesh(data=2, rank=rank)
                   for m in r["meshes"])
        assert all(m == port_mesh.Mesh(data=1, model=2, rank=rank)
                   for m in r["model_meshes"])


def test_a_model_axis_replicates_one_process(tmp_path, monkeypatch):
    """``TPU.MESH_SHAPE [1, 2]`` on two gloo processes: both ranks hold data
    index 0 and the whole global batch of 2; ``all_gather_rows`` over a data
    axis of 1 is each rank's own rows, with no collective; one train step and the flip-tested eval step leave both
    ranks bit for bit equal (state, gradients, metrics, heatmaps) and bit
    for bit one process's step whose BatchNorms take the global path with
    the all-reduce as the identity: the ranks' sums and count are twice one
    copy's, their cotangents summed twice one copy's, and the gradients
    averaged over two equal copies, all exact in float32 (one intra-op
    thread on both sides). A ``Trainer`` over that mesh loads the whole
    global batch a rank."""
    import fami_pose_torch.models.layers as port_layers
    from fami_pose_torch.data.loader import prepare_train_batch
    from test_torch_trainer import _cfg

    rs = np.random.RandomState(5)
    batch = (rs.randint(0, 256, size=(2, 64, 64, 3)).astype(np.uint8),
             rs.randint(0, 256, size=(2, 64, 64, 12)).astype(np.uint8),
             (rs.rand(2, 17, 2) * 64).astype(np.float32),
             (rs.rand(2, 17) > 0.2).astype(np.float32))
    kw = dict(extra=TINY_EXTRA, num_joints=17, num_sup=4, feat_channels=8,
              feat_hw=(16, 16), dcn_offset_groups=4, dcn_max_offset=2)
    torch.manual_seed(0)
    base = FAMIPose(**kw)
    cfg = _cfg(str(tmp_path / "out"), 1)
    prepare = (2, (64, 64), (16, 16))
    r0, r1 = run_ranks("model_axis", 2, tmp_path / "ranks", dict(
        model_kw=kw, state_dict=base.state_dict(), cfg=cfg._to_plain(),
        batch=batch, prepare=prepare, mesh_shape=[1, 2]))

    model = FAMIPose(**kw).train()
    model.load_state_dict(base.state_dict())
    monkeypatch.setattr(port_layers, "all_reduce_sum", lambda x: x)
    for bn in model.modules():
        if isinstance(bn, BatchNorm):
            bn.mesh = port_mesh.Mesh(data=1, model=2)
    opt, sched = build_optimizer(cfg, model, steps_per_epoch=5)
    pb = prepare_train_batch(*batch, *prepare)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, metrics = make_train_step()(TrainState(model, opt, sched), pb)
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.eval()
        heatmaps = make_eval_step(model, flip_test=True)(pb["kf"], pb["sup"])
    finally:
        torch.set_num_threads(threads)
    ref = {"state_dict": model.state_dict(), "grads": grads,
           "metrics": metrics, "heatmaps": dict(enumerate(heatmaps))}

    for rank, r in enumerate((r0, r1)):
        assert r["mesh"] == port_mesh.Mesh(data=1, model=2, rank=rank)
        assert r["mesh"].data_index == 0 and r["slice"] == slice(0, 4)
        assert torch.equal(r["rows"], torch.full((2, 3), float(rank)))
        assert r["trainer"] == (r["mesh"], int(cfg.TRAIN.BATCH_SIZE_PER_GPU),
                                0, 1)
        r["heatmaps"] = dict(enumerate(r["heatmaps"]))
    for key, want in ref.items():
        assert list(r0[key]) == list(r1[key]) == list(want), key
        for k, v in want.items():
            assert torch.equal(r0[key][k], r1[key][k]), (key, k)
            assert torch.equal(r0[key][k], v), (key, k)


def test_every_rank_builds_the_same_seeded_weights(tmp_path):
    """Nothing broadcasts the initial weights: each rank's ``Trainer``
    draws them from ``cfg.SEED``, as every JAX process does. Both ranks'
    models equal one process's ``Trainer``'s bit for bit, over a mesh of 2
    whose ranks each load half of the global batch of 2 x 4."""
    from test_torch_trainer import _cfg

    cfg = _cfg(str(tmp_path / "out"), 1)
    cfg.TPU.MESH_SHAPE = [-1, 1]
    ranks = run_ranks("trainer_init", 2, tmp_path / "ranks",
                      dict(cfg=cfg._to_plain()))
    one = Trainer(cfg, dataset=SyntheticPoseDataset(8, (64, 64), 4),
                  device="cpu")
    assert one.mesh.data == 1 and one.loader.local_batch_size == 4
    want = one.model.state_dict()
    for rank, r in enumerate(ranks):
        assert r["mesh"] == port_mesh.Mesh(data=2, rank=rank)
        assert r["local_batch"] == 4
        assert list(r["state"]) == list(want)
        assert all(torch.equal(r["state"][k], want[k]) for k in want)


def test_sync_batch_norm_matches_flax_on_the_whole_batch(tmp_path):
    """Two ranks of 2 samples each against flax's train-mode BatchNorm on
    all 4 (``use_fast_variance``, momentum 0.9): the output and the input
    gradient of ``sum(y * cot)`` in each rank's rows, the scale and bias
    gradients summed over the ranks (the train step's average, times 2),
    and the running statistics, equal on both ranks; plainly and with the
    forward recomputed in the backward."""
    rs = np.random.RandomState(3)
    x = (rs.randn(4, 6, 5, 7) * 2 + 0.5).astype(np.float32)
    cot = rs.randn(*x.shape).astype(np.float32)
    scale = (1 + 0.3 * rs.randn(6)).astype(np.float32)
    bias = (0.2 * rs.randn(6)).astype(np.float32)
    ranks = run_ranks("batch_norm", 2, tmp_path, dict(
        x=x, cot=cot, scale=scale, bias=bias, local=2))

    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      axis=-1)
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    variables = bn.init(jax.random.PRNGKey(0), xh)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def loss(p, xin):
        y, upd = bn.apply({"params": p, **{"batch_stats":
                                           variables["batch_stats"]}},
                          xin, mutable=["batch_stats"])
        return jnp.sum(y * cot.transpose(0, 2, 3, 1)), (y, upd)

    (_, (y, upd)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, xh)
    y = np.asarray(y).transpose(0, 3, 1, 2)
    gx = np.asarray(gx).transpose(0, 3, 1, 2)
    stats = upd["batch_stats"]
    for remat in (False, True):
        got_y = torch.cat([r[remat]["y"] for r in ranks]).numpy()
        got_dx = torch.cat([r[remat]["dx"] for r in ranks]).numpy()
        np.testing.assert_allclose(got_y, y, atol=2e-5)
        np.testing.assert_allclose(got_dx, gx, atol=2e-5)
        for name, ref in (("dscale", gp["scale"]), ("dbias", gp["bias"])):
            got = sum(r[remat][name] for r in ranks).numpy()
            np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4,
                                       atol=2e-5, err_msg=name)
        for name, ref in (("mean", stats["mean"]), ("var", stats["var"])):
            assert torch.equal(ranks[0][remat][name], ranks[1][remat][name])
            np.testing.assert_allclose(ranks[0][remat][name].numpy(),
                                       np.asarray(ref), atol=2e-5)
    for r in ranks:
        for k in r[False]:
            assert torch.equal(r[False][k], r[True][k]), k


# -- a data axis of 1 ------------------------------------------------------------------

def test_a_data_axis_of_one_is_the_single_device_step(monkeypatch):
    """With one process the mesh of ``[-1, 1]`` has a data axis of 1: the
    train step (BatchNorm included) and the eval step issue no collective,
    and their results are bit for bit those of the steps without a mesh."""
    def refuse(*args, **kwargs):
        raise AssertionError("a collective on a data axis of 1")

    for name in ("all_reduce", "all_gather", "broadcast", "barrier"):
        monkeypatch.setattr(dist, name, refuse)
    mesh = port_mesh.build_mesh([-1, 1])
    assert mesh.data == 1 and not dist.is_initialized()
    torch.manual_seed(0)
    rs = np.random.RandomState(1)
    batch = {"kf": torch.from_numpy(rs.randn(2, 3, 32, 32).astype(np.float32)),
             "sup": torch.from_numpy(
                 rs.randn(2, 12, 32, 32).astype(np.float32)),
             "target": torch.from_numpy(rs.rand(2, 17, 8, 8).astype(np.float32)),
             "target_weight": torch.ones(2, 17)}
    base = FAMIPose(extra=TINY_EXTRA, num_joints=17, num_sup=4,
                    feat_channels=8, feat_hw=(8, 8), dcn_offset_groups=4,
                    dcn_max_offset=2).train()
    from fami_pose_torch.config import get_cfg

    cfg = get_cfg()
    results = []
    for m in (None, mesh):
        model = FAMIPose(extra=TINY_EXTRA, num_joints=17, num_sup=4,
                         feat_channels=8, feat_hw=(8, 8), dcn_offset_groups=4,
                         dcn_max_offset=2).train()
        model.load_state_dict(base.state_dict())
        opt, sched = build_optimizer(cfg, model, steps_per_epoch=5)
        state, metrics = make_train_step(mesh=m)(
            TrainState(model, opt, sched), batch)
        assert all(bn.mesh is None for bn in model.modules()
                   if isinstance(bn, BatchNorm))
        model.eval()
        heatmaps = make_eval_step(model, flip_test=True, mesh=m)(
            batch["kf"], batch["sup"])
        results.append((model.state_dict(), metrics, heatmaps))
    (sd0, m0, h0), (sd1, m1, h1) = results
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    assert list(m0) == list(m1)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(a, b) for a, b in zip(h0, h1))
    assert sync_batch_norm(base, mesh) is base
    assert all(bn.mesh is None for bn in base.modules()
               if isinstance(bn, BatchNorm))
