"""The port's compact gradient exchange (tpusplat_torch/parallel/
compact_grad.py) over gloo on the CPU, four processes on a 1x4 mesh started
once for the module, on tests/test_compact_grad.py's scene (4096 Gaussians,
128x256, SH1, strip_gauss_mult 1.5: strip compaction active, asserted):

  * the compact step against the dense one, with one and two cameras a
    rank (parameters within 3e-6, tests/test_compact_grad.py's bound; Adam's
    moments, which hold the reduced gradient's magnitude, within 1e-5 of
    their largest magnitude);
  * the overlap step with the compact exchange against the dense
    monolithic step, parameters and moments;
  * an all-to-all bucket overflow gating the step to a no-op;
  * the bucket capacity bit for bit against the JAX package's, and the
    one-process emulation of the exchange."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from tpusplat_torch.config import RenderConfig

torch.set_num_threads(2)

FIELDS = ("means", "log_scales", "quats", "opacities", "sh")
CN, CW, CH = 4096, 128, 256
CCFG = dict(sh_degree=1, capacity_mult=16, strip_gauss_mult=1.5, max_per_tile=2048,
            grad_exchange="compact", grad_a2a_mult=2.0)


def _eyes(batch):
    return [[math.sin(i) * 2, 0.3, 6.0] for i in range(batch)]


def _jax_params(n, seed, sort_by_y=False):
    from tpusplat.io.synthetic import random_scene
    from tpusplat.types import to_numpy

    p = dataclasses.asdict(to_numpy(random_scene(n, seed=seed, sh_degree=1,
                                                 scale_range=(0.05, 0.3))))
    if sort_by_y:  # ids follow screen rows: a strip's stream ids nearly contiguous
        order = np.argsort(p["means"][:, 1], kind="stable")
        p = {k: v[order] for k, v in p.items()}
    return p  # plain numpy: the worker processes never import JAX


def _torch_params(p):
    from tpusplat_torch import convert

    return convert.params_from_numpy(**p, device="cpu")


def _cams(width, height, batch):
    from tpusplat_torch.camera import look_at_camera

    return [look_at_camera(e, [0, 0, 0], width, height, fov_deg=60.0, device="cpu")
            for e in _eyes(batch)]


def _targets(batch, height, width):
    return np.random.default_rng(0).uniform(0, 1, (batch, height, width, 3)).astype(np.float32)


def _worker(rank, dev, inputs, out_dir):
    """One rank of the 1x4 mesh; rank 0 saves the results."""
    from tpusplat_torch.parallel import sharded
    from tpusplat_torch.parallel.mesh import make_render_mesh
    from tpusplat_torch.train import step as tstep

    opt = tstep.make_optimizer()
    mesh = make_render_mesh(1, 4)
    cfg = RenderConfig(**CCFG)
    tgt = torch.from_numpy(inputs["targets"])
    steps = {}
    for batch in (1, 2):
        cams = _cams(CW, CH, batch)
        state = sharded.shard_state(tstep.create_train_state(_torch_params(inputs["scene"])),
                                    mesh)
        for name, c in (("compact", cfg), ("dense", dataclasses.replace(cfg, grad_exchange="dense"))):
            s1, m = sharded.sharded_train_step(state, cams, tgt[:batch], c, opt, mesh)
            steps[f"{batch}_{name}"] = _summary(s1, m, mesh)
        if batch == 1:
            s1, m = sharded.sharded_train_step_overlap(state, cams, tgt[:1], cfg, opt, mesh)
            steps["1_overlap"] = _summary(s1, m, mesh)
    # The bucket overflow gate: ids sorted by screen row, a tiny bucket.
    state = sharded.shard_state(tstep.create_train_state(_torch_params(inputs["scene_y"])),
                                mesh)
    s1, m = sharded.sharded_train_step(state, _cams(CW, CH, 1), tgt[:1],
                                       dataclasses.replace(cfg, grad_a2a_mult=0.01), opt, mesh)
    steps["gated"] = _summary(s1, m, mesh)
    if rank == 0:
        torch.save(steps, f"{out_dir}/result.pt")


def _summary(state, metrics, mesh):
    from tpusplat_torch.parallel import sharded

    full = sharded.gather_state(state, mesh)
    return dict(params={f: getattr(full.params, f) for f in FIELDS},
                mu={f: full.mu[f] for f in FIELDS}, nu={f: full.nu[f] for f in FIELDS},
                step=int(state.step),
                **{k: float(v) if k == "loss" else int(v) for k, v in metrics.items()})


def assert_moments_close(got, want, tol):
    """Adam's moments (after one step mu = 0.1 g, nu = 0.001 g^2) of every
    field within ``tol`` of the largest magnitude of the field's wanted
    moment: a gradient scaled, or a peer's partial dropped or counted twice,
    shows here, where the first update, -lr sign(g), hides it."""
    for m in ("mu", "nu"):
        for f in FIELDS:
            w = want[m][f].numpy()
            scale = np.abs(w).max()
            assert scale > 0, f"{m} {f} is zero"
            np.testing.assert_allclose(got[m][f].numpy(), w, rtol=0, atol=tol * scale,
                                       err_msg=f"{m} {f}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tpusplat_torch.parallel.launch import spawn

    out = tmp_path_factory.mktemp("compact")
    inputs = dict(scene=_jax_params(CN, 3), scene_y=_jax_params(CN, 3, sort_by_y=True),
                  targets=_targets(2, CH, CW))
    spawn(_worker, 4, (inputs, str(out)), init_file=str(out / "init"), device="cpu")
    return inputs, torch.load(out / "result.pt", weights_only=False)


def test_compaction_active_in_the_compact_fixture():
    cfg = RenderConfig(**CCFG)
    tiles_y = cfg.tile_grid(CW, CH)[1]
    nrows = -(-tiles_y // 4)
    gcap = cfg.strip_gauss_capacity(CN, nrows, tiles_y)
    assert gcap is not None and gcap < CN


@pytest.mark.parametrize("batch", [1, 2])
def test_compact_exchange_equals_dense(runs, batch):
    """tests/test_compact_grad.py::test_train_step_compact_equals_dense on a
    1x4 mesh: zero bucket overflow, the step applied, the parameters within
    3e-6 of the dense exchange's."""
    _, res = runs
    comp, dense = res[f"{batch}_compact"], res[f"{batch}_dense"]
    assert comp["a2a_overflow"] == comp["gauss_overflow"] == comp["capacity_overflow"] == 0
    assert comp["step"] == dense["step"] == 1
    np.testing.assert_allclose(comp["loss"], dense["loss"], rtol=1e-6)
    for f in FIELDS:
        np.testing.assert_allclose(comp["params"][f].numpy(), dense["params"][f].numpy(),
                                   atol=3e-6, err_msg=f)
    assert_moments_close(comp, dense, 1e-5)


def test_overlap_compact_matches_dense_monolithic(runs):
    _, res = runs
    ref, got = res["1_dense"], res["1_overlap"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["params"]["means"].numpy(), ref["params"]["means"].numpy(),
                               atol=3e-6)
    assert_moments_close(got, ref, 1e-4)


def test_a2a_bucket_overflow_gates_the_step(runs):
    inputs, res = runs
    got = res["gated"]
    assert got["a2a_overflow"] > 0, "the fixture failed to overflow a bucket"
    assert got["step"] == 0
    for f in FIELDS:
        np.testing.assert_array_equal(got["params"][f].numpy(),
                                      inputs["scene_y"][f], err_msg=f)
        assert not got["mu"][f].any() and not got["nu"][f].any(), f


@pytest.mark.parametrize("gcap,shards,n_local", [(87040, 2, 50000), (868352, 4, 350000),
                                                 (3072, 4, 1024), (5120, 3, 3000),
                                                 (2048, 8, 512)])
def test_a2a_bucket_cap_matches_jax(gcap, shards, n_local):
    from tpusplat.config import RenderConfig as JaxConfig
    from tpusplat.parallel import compact_grad as jcg
    from tpusplat_torch.parallel import compact_grad as tcg

    for mult in (0.01, 1.3, 2.0):
        jst = jcg.CompactStatic(cfg=JaxConfig(grad_a2a_mult=mult), width=0, height=0, nrows=0,
                                cap_shard=0, gcap=gcap, n_total=n_local * shards,
                                n_local=n_local, n_shards=shards, axis=None)
        tst = tcg.CompactStatic(cfg=RenderConfig(grad_a2a_mult=mult), width=0, height=0,
                                nrows=0, cap_shard=0, gcap=gcap, n_total=n_local * shards,
                                n_local=n_local, n_shards=shards)
        assert tcg.a2a_bucket_cap(tst) == jcg.a2a_bucket_cap(jst)


def test_emulated_exchange_renders_the_dense_strip():
    """exchange_render_emulated's forward is the strip of the dense path;
    its backward runs both new reduce modes and returns a full-size
    cotangent, zero past the first shard."""
    from tpusplat_torch.ops.binning import bin_and_sort
    from tpusplat_torch.ops.preprocess import preprocess
    from tpusplat_torch.ops.rasterize import rasterize
    from tpusplat_torch.parallel import compact_grad as tcg

    params = _torch_params(_jax_params(CN, 3))
    cfg = RenderConfig(**CCFG)
    cam = _cams(CW, CH, 1)[0]
    tiles_y = cfg.tile_grid(CW, CH)[1]
    nrows, row0 = 4, 4
    gcap = cfg.strip_gauss_capacity(CN, nrows, tiles_y)
    st = tcg.CompactStatic(cfg=cfg, width=CW, height=CH, nrows=nrows,
                           cap_shard=cfg.instance_capacity(CN // 4), gcap=gcap, n_total=CN,
                           n_local=CN // 4, n_shards=4)
    pg = preprocess(params, cam, cfg)
    table = tcg.pack_exchange_table(pg).detach()[None].requires_grad_(True)
    img, counters = tcg.exchange_render_emulated(table, st, row0)
    binned = bin_and_sort(pg, CW, CH, cfg, row0, nrows, st.cap_shard, gauss_capacity=gcap)
    want, _ = rasterize(pg, binned, CW, CH, cfg, row0, nrows)
    assert int(counters.sum()) == 0 and binned.stream_ids is not None
    np.testing.assert_allclose(img[0].detach().numpy(), want.detach().numpy(), atol=1e-6)
    (d_table,) = torch.autograd.grad(img.sum(), table)
    assert d_table.shape == (1, CN, 16) and torch.isfinite(d_table).all()
    assert not d_table[0, CN // 4:].any() and not d_table[0, :, 9:].any()
    assert d_table[0, :, :9].abs().sum() > 0
