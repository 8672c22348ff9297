"""The port's collectives (tpusplat_torch/parallel/collectives.py) over gloo
on the CPU, three processes started once for the module: the ring
all-reduce against ``all_reduce`` at 3 ranks and at 1, the two gathers and
their different backwards, the SSIM halo exchange and its backward, the
compact exchange's all-to-all; and the byte accounting against the JAX
package's."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

WORLD = 3
SHAPES = dict(a=(5, 3), b=(7,), c=(), d=(2, 2, 2))


def _vals(rank, salt):
    g = torch.Generator().manual_seed(100 * salt + rank)
    return {k: torch.randn(s, generator=g) for k, s in SHAPES.items()}


def _weights(rank, shape, salt):
    return torch.randn(shape, generator=torch.Generator().manual_seed(1000 * salt + rank))


def _worker(rank, dev, out_dir):
    import torch.distributed as dist

    from tpusplat_torch.parallel import collectives as col
    from tpusplat_torch.parallel.compact_grad import exchange_buckets

    world = dist.group.WORLD
    singles = [dist.new_group([r]) for r in range(WORLD)]
    res = {}

    x = _vals(rank, 1)
    res["ring"] = col.ring_all_reduce(x, world)
    ref = {k: v.clone() for k, v in x.items()}
    for v in ref.values():
        dist.all_reduce(v)
    res["all_reduce"] = ref
    res["ring_1"] = col.ring_all_reduce(x, singles[rank])
    res["x"] = x

    # The attribute gather: rank r holds rows [2r, 2r + 2); its backward sums.
    a = torch.full((2, 3), float(rank), requires_grad=True)
    y = col.all_gather(a, world, dim=0)
    (ga,) = torch.autograd.grad((y * _weights(rank, y.shape, 2)).sum(), a)
    res["gather"], res["gather_grad"] = y.detach(), ga

    # The strip gather: every rank then takes the same loss; its backward
    # keeps the rank's own slice.
    s = torch.full((1, 4, 2), float(rank), requires_grad=True)
    z = col.gather_strips(s, world, dim=1)
    (gs,) = torch.autograd.grad((z * _weights(0, z.shape, 3)).sum(), s)
    res["strips"], res["strips_grad"] = z.detach(), gs

    # The halo exchange of 2 rows around a strip of 6.
    img = (torch.arange(6.0)[None, :, None] + 10 * rank).requires_grad_(True)
    top, bot = col.halo_exchange(img, world, 2)
    loss = (top * _weights(rank, top.shape, 4)).sum() + (bot * _weights(rank, bot.shape, 5)).sum()
    (gi,) = torch.autograd.grad(loss, img)
    res["top"], res["bot"], res["halo_grad"] = top.detach(), bot.detach(), gi

    # The compact exchange's all-to-all: bucket k goes to rank k.
    cap = 4
    targets = torch.arange(WORLD * cap, dtype=torch.int32) + 100 * rank
    g_red = torch.arange(9 * WORLD * cap, dtype=torch.float32).reshape(9, -1) + 1000 * rank
    res["a2a"] = exchange_buckets(g_red, targets, WORLD, world)
    torch.save(res, f"{out_dir}/r{rank}.pt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tpusplat_torch.parallel.launch import spawn

    out = tmp_path_factory.mktemp("collectives")
    spawn(_worker, WORLD, (str(out),), init_file=str(out / "init"), device="cpu")
    return [torch.load(out / f"r{r}.pt", weights_only=False) for r in range(WORLD)]


def test_ring_all_reduce_matches_all_reduce_at_3_ranks(runs):
    want = {k: sum(_vals(r, 1)[k] for r in range(WORLD)) for k in SHAPES}
    for res in runs:
        assert res["ring"].keys() == SHAPES.keys()
        for k in SHAPES:
            assert res["ring"][k].shape == SHAPES[k]
            torch.testing.assert_close(res["ring"][k], res["all_reduce"][k], atol=1e-6,
                                       rtol=1e-6)
            torch.testing.assert_close(res["ring"][k], want[k], atol=1e-6, rtol=1e-6)
    for k in SHAPES:  # every rank gets the same bits
        assert all(torch.equal(runs[0]["ring"][k], r["ring"][k]) for r in runs)


def test_ring_all_reduce_is_the_identity_at_1_rank(runs):
    for res in runs:
        for k in SHAPES:
            assert torch.equal(res["ring_1"][k], res["x"][k])


def test_attribute_gather_backward_sums_over_ranks(runs):
    want_y = torch.cat([torch.full((2, 3), float(r)) for r in range(WORLD)])
    for rank, res in enumerate(runs):
        assert torch.equal(res["gather"], want_y)
        w = sum(_weights(r, want_y.shape, 2) for r in range(WORLD))
        torch.testing.assert_close(res["gather_grad"], w[2 * rank:2 * rank + 2])


def test_strip_gather_backward_takes_the_own_slice(runs):
    w = _weights(0, (1, 4 * WORLD, 2), 3)
    for rank, res in enumerate(runs):
        assert torch.equal(res["strips"][0, ::4, 0], torch.arange(float(WORLD)))
        torch.testing.assert_close(res["strips_grad"], w[:, 4 * rank:4 * rank + 4])


def test_halo_exchange_and_its_backward(runs):
    for rank, res in enumerate(runs):
        prev_rows = torch.tensor([4.0, 5.0]) + 10 * (rank - 1)
        next_rows = torch.tensor([0.0, 1.0]) + 10 * (rank + 1)
        top = prev_rows if rank > 0 else torch.zeros(2)
        bot = next_rows if rank < WORLD - 1 else torch.zeros(2)
        assert torch.equal(res["top"][0, :, 0], top)
        assert torch.equal(res["bot"][0, :, 0], bot)
        # Rows 0-1 fed the previous rank's bottom halo, rows 4-5 the next's top.
        want = torch.zeros((1, 6, 1))
        if rank > 0:
            want[:, :2] += _weights(rank - 1, (1, 2, 1), 5)
        if rank < WORLD - 1:
            want[:, 4:] += _weights(rank + 1, (1, 2, 1), 4)
        torch.testing.assert_close(res["halo_grad"], want)


def test_exchange_buckets_sends_bucket_k_to_rank_k(runs):
    cap = 4
    for rank, res in enumerate(runs):
        g_x, ids_x = res["a2a"]
        assert g_x.shape == (9, WORLD * cap) and ids_x.shape == (WORLD * cap,)
        for b in range(WORLD):  # block b came from peer b: its bucket for this rank
            want_ids = torch.arange(cap, dtype=torch.int32) + rank * cap + 100 * b
            assert torch.equal(ids_x[b * cap:(b + 1) * cap], want_ids)
            want_g = (torch.arange(9 * WORLD * cap, dtype=torch.float32).reshape(9, -1)
                      + 1000 * b)[:, rank * cap:(rank + 1) * cap]
            assert torch.equal(g_x[:, b * cap:(b + 1) * cap], want_g)


@pytest.mark.parametrize("num_params,axis_size", [(1_400_000 * 59, 2), (1000, 1), (12345, 3),
                                                  (7, 8)])
def test_allreduce_bytes_matches_jax(num_params, axis_size):
    from tpusplat.parallel import collectives as jcol
    from tpusplat_torch.parallel import collectives as tcol

    assert tcol.allreduce_bytes(num_params, axis_size) == jcol.allreduce_bytes(num_params,
                                                                               axis_size)
    assert tcol.tile_exchange_bytes(num_params, axis_size) == \
        jcol.tile_exchange_bytes(num_params, axis_size)
    assert (tcol.ATTR_COLS, tcol.GRAD_ROWS) == (jcol.ATTR_COLS, jcol.GRAD_ROWS)
    assert np.isfinite(tcol.allreduce_bytes(num_params, axis_size)["bytes_per_step"])
