"""The route of tpusplat_torch.train.step.apply_gradients's update and the
guard of the Adam kernel's wrapper (tpusplat_torch.train.adam). A CPU call
takes the plain adam_update and its torch.where gate; a call off the CPU
takes the kernel, handed fresh output buffers when eager and the state's own
buffers in the body of a compiled step whose state is donated, never in the
warm-up calls before a capture. There is no card, so meta tensors stand in
for CUDA ones, and the kernel's C call is stubbed while its wrapper
records what it was handed. The wrapper refuses what the kernel does not take with ValueError."""

import pathlib
import re

import pytest
import torch

from tpusplat_torch import compiled
from tpusplat_torch.train import adam
from tpusplat_torch.train import step as tstep
from tpusplat_torch.types import GaussianParams

N = 10  # N * 3 and N floats are not whole float4s
OPT = tstep.make_optimizer(scene_extent=2.0, means_lr_max_steps=7)
SHAPES = dict(means=(N, 3), log_scales=(N, 3), quats=(N, 4), opacities=(N,), sh=(N, 16, 3))


def _state(device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    params = GaussianParams(**{k: torch.randn(s, generator=g) for k, s in SHAPES.items()},
                            alive=torch.ones(N, dtype=torch.bool))
    state = tstep.create_train_state(params)
    state.mu = {k: torch.randn(s, generator=g) * 1e-3 for k, s in SHAPES.items()}
    state.nu = {k: torch.rand(s, generator=g) * 1e-6 for k, s in SHAPES.items()}
    state.count = {k: torch.tensor(3, dtype=torch.int32) for k in SHAPES}
    grads = {k: torch.randn(s, generator=g) * 1e-2 for k, s in SHAPES.items()}
    aux = dict(capacity_overflow=torch.tensor(0, dtype=torch.int32),
               gauss_overflow=torch.tensor(0, dtype=torch.int32),
               tile_overflow=torch.tensor(0, dtype=torch.int32),
               num_instances=torch.tensor(7, dtype=torch.int32),
               visible=torch.rand(N, generator=g) > 0.3, radius=torch.rand(N, generator=g) * 5)
    loss = torch.tensor(0.5)
    if device != "cpu":
        leaves = []
        struct = compiled.flatten(state, leaves)
        state = compiled.unflatten(struct, iter([t.to(device) for t in leaves]))
        grads = {k: v.to(device) for k, v in grads.items()}
        aux = {k: v.to(device) for k, v in aux.items()}
        loss = loss.to(device)
    return state, loss, aux, grads


@pytest.fixture
def kernel_calls(monkeypatch):
    """The kernel's wrapper with its checks and its C call stubbed: each
    launch is recorded as its inputs and outputs, and counted as the real
    one counts."""
    calls, launch = [], adam.launch

    def recorded(params, grads, mu, nu, count, schedules, overflow, hyper, p_out, m_out,
                 v_out):
        calls.append(dict(inputs=(params, mu, nu), outputs=(p_out, m_out, v_out),
                          schedules=schedules, hyper=hyper, overflow=overflow))
        launch(params, grads, mu, nu, count, schedules, overflow, hyper, p_out, m_out, v_out)

    monkeypatch.setattr(adam, "check_inputs", lambda *a: None)
    monkeypatch.setattr(adam, "launch", recorded)
    monkeypatch.setattr(adam, "_kernel", lambda: lambda *a: 0)
    monkeypatch.setattr(adam._build, "stream_ptr", lambda dev: 0)
    return calls


def _tensors(state):
    trainable, _ = tstep.split_trainable(state.params)
    return [t for d in (trainable, state.mu, state.nu) for t in d.values()]


def test_eager_call_off_the_cpu_hands_the_kernel_fresh_buffers(kernel_calls):
    state, loss, aux, grads = _state("meta")
    old = _tensors(state)
    versions = [t._version for t in old]
    launches, in_place = adam.LAUNCHES, adam.IN_PLACE_LAUNCHES
    new, _ = tstep.apply_gradients(state, loss, aux, grads, OPT)
    assert adam.LAUNCHES == launches + 1 and adam.IN_PLACE_LAUNCHES == in_place
    (call,) = kernel_calls
    outs = [t for d in call["outputs"] for t in d.values()]
    assert all(o is not t for o, t in zip(outs, old))
    assert [id(t) for t in _tensors(new)] == [id(t) for t in outs]
    assert [t._version for t in old] == versions  # nothing wrote into the old state
    assert all(t is o for t, o in zip(_tensors(state), old))
    assert call["schedules"] == {k: OPT.schedule(k) for k in tstep.TRAINABLE}
    assert call["hyper"] == (tstep.B1, tstep.B2, tstep.EPS)
    assert call["overflow"] == (aux["capacity_overflow"], aux["gauss_overflow"],
                                aux["tile_overflow"])


def _adam_step(state, loss, aux, grads, optimizer):
    return tstep.apply_gradients(state, loss, aux, grads, optimizer)


def test_donated_body_hands_the_kernel_the_state_buffers_and_warm_ups_do_not(kernel_calls):
    step = compiled.compile_step(_adam_step, static_argnames=("optimizer",),
                                 donate={"state": 0})
    state, loss, aux, grads = _state("meta")
    in_place = adam.IN_PLACE_LAUNCHES
    new, _ = step(state, loss, aux, grads, OPT)
    (entry,) = step._entries.values()
    lo, hi = entry.ranges["state"]
    buffers = entry.inputs[lo:hi]
    (call,) = kernel_calls
    outs = [t for d in call["outputs"] for t in d.values()]
    ins = [t for d in call["inputs"] for t in d.values()]
    assert all(o is i for o, i in zip(outs, ins))
    assert all(any(o is b for b in buffers) for o in outs)
    assert adam.IN_PLACE_LAUNCHES == in_place + 1
    assert all(any(t is b for b in buffers) for t in _tensors(new))  # returned as the buffers
    assert not any(compiled.donated(b) for b in buffers)  # only while the body runs

    kernel_calls.clear()
    entry.warm_up()
    assert len(kernel_calls) == compiled.WARMUP_CALLS
    for call in kernel_calls:
        outs = [t for d in call["outputs"] for t in d.values()]
        assert not any(o is b for o in outs for b in buffers)
    assert adam.IN_PLACE_LAUNCHES == in_place + 1


def test_undonated_body_writes_fresh_buffers(kernel_calls):
    step = compiled.compile_step(_adam_step, static_argnames=("optimizer",))
    step(*_state("meta"), OPT)
    (call,) = kernel_calls
    assert all(o is not i for od, idict in zip(call["outputs"], call["inputs"])
               for o, i in zip(od.values(), idict.values()))


def test_cpu_route_runs_the_plain_update(kernel_calls, monkeypatch):
    calls = []
    plain = tstep.adam_update

    def recorded(*a, **k):
        calls.append(a)
        return plain(*a, **k)

    monkeypatch.setattr(tstep, "adam_update", recorded)
    state, loss, aux, grads = _state("cpu")
    launches = adam.LAUNCHES
    new, _ = tstep.apply_gradients(state, loss, aux, grads, OPT)
    assert len(calls) == 1 and not kernel_calls and adam.LAUNCHES == launches
    want, mu, nu, count = plain(OPT, tstep.split_trainable(state.params)[0], grads, state.mu,
                                state.nu, state.count)
    for k in tstep.TRAINABLE:
        assert torch.equal(getattr(new.params, k), want[k])
        assert torch.equal(new.mu[k], mu[k]) and torch.equal(new.nu[k], nu[k])
        assert int(new.count[k]) == int(count[k]) == 4


def _misaligned(shape):
    flat = torch.zeros(int(torch.tensor(shape).prod()) + 1)
    return flat[1:].view(shape)


def _inputs(**replace):
    """fused_adam's inputs on the CPU, one tensor replaced: (group, what) ->
    tensor, or 'overflow' -> a tuple."""
    state, _, aux, grads = _state("cpu")
    params = dict(tstep.split_trainable(state.params)[0])
    d = dict(param=params, grad=dict(grads), mu=dict(state.mu), nu=dict(state.nu),
             count=dict(state.count))
    overflow = (aux["capacity_overflow"], aux["gauss_overflow"], aux["tile_overflow"])
    for key, t in replace.items():
        if key == "overflow":
            overflow = t
        else:
            group, what = key.split("__")
            d[what][group] = t
    return d["param"], d["grad"], d["mu"], d["nu"], d["count"], overflow


# (what is wrong, the replaced input, the message)
REFUSED = [
    ("float64 param", dict(means__param=torch.zeros(N, 3, dtype=torch.float64)),
     "means param must be contiguous float32"),
    ("float16 grad", dict(sh__grad=torch.zeros(N, 16, 3, dtype=torch.float16)),
     "sh grad must be contiguous float32"),
    ("grad of another shape", dict(quats__grad=torch.zeros(N, 3)), "quats grad must be"),
    ("non-contiguous mu", dict(log_scales__mu=torch.zeros(3, N).t()), "not contiguous"),
    ("non-contiguous nu", dict(sh__nu=torch.zeros(N, 3, 16).transpose(1, 2)),
     "not contiguous"),
    ("misaligned nu", dict(means__nu=_misaligned((N, 3))), "means nu must be 16-byte aligned"),
    ("misaligned param", dict(opacities__param=_misaligned((N,))),
     "opacities param must be 16-byte aligned"),
    ("int64 count", dict(sh__count=torch.tensor(0)), "must be 0-d int32"),
    ("[1] count", dict(quats__count=torch.zeros(1, dtype=torch.int32)), "must be 0-d int32"),
    ("float overflow", dict(overflow=(torch.tensor(0.0),) * 3), "must be 0-d int32"),
    ("two overflow counters", dict(overflow=(torch.tensor(0, dtype=torch.int32),) * 2),
     "three overflow counters"),
    ("mixed devices", dict(means__grad=torch.zeros(N, 3, device="meta")), "one device"),
    ("CPU tensors", {}, "no kernel for tensors on cpu"),
]


@pytest.mark.parametrize("what,replace,message", REFUSED, ids=[r[0] for r in REFUSED])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(what, replace, message):
    params, grads, mu, nu, count, overflow = _inputs(**replace)
    launches = adam.LAUNCHES
    with pytest.raises(ValueError, match=re.escape(message)):
        adam.fused_adam(params, grads, mu, nu, count, {k: OPT.schedule(k) for k in SHAPES},
                        overflow, tstep.B1, tstep.B2, tstep.EPS)
    assert adam.LAUNCHES == launches


def test_kernel_wrapper_refuses_group_counts():
    params, grads, mu, nu, count, overflow = _inputs()
    with pytest.raises(ValueError, match="no mu for the group 'sh'"):
        adam.check_inputs(params, grads, {k: v for k, v in mu.items() if k != "sh"}, nu,
                          count, overflow)
    many = {f"g{i}": torch.zeros(4) for i in range(adam.MAX_GROUPS + 1)}
    with pytest.raises(ValueError, match="1 to 8 parameter groups"):
        adam.check_inputs(many, many, many, many, {}, overflow)
    with pytest.raises(ValueError, match="1 to 8 parameter groups"):
        adam.check_inputs({}, {}, {}, {}, {}, overflow)


@pytest.mark.parametrize("schedule,mode", [
    ((1e-3, 0.0, 1.0, 0), adam.CONSTANT),
    ((1.6e-4, 1.6e-6, 0.01, 30_000), adam.DECAY_FLOOR),
    ((1e-4, 2e-4, 2.0, 10), adam.DECAY_CEILING),
])
def test_schedule_modes(schedule, mode):
    fields = adam._schedule(*schedule)
    assert fields["lr_mode"] == mode
    assert (fields["lr"], fields["lr_end"], fields["lr_rate"], fields["lr_steps"]) == schedule


@pytest.mark.parametrize("kw", [dict(), dict(means_lr_max_steps=0),
                                dict(means_lr=1e-4, means_lr_final=2e-4, means_lr_max_steps=5)])
@pytest.mark.parametrize("count", [0, 2, 5, 9])
def test_learning_rate_follows_the_schedule(kw, count):
    """Optimizer.learning_rate, the plain route's, is optax's schedule of
    Optimizer.schedule's tuple, the kernel's."""
    opt = tstep.make_optimizer(scene_extent=3.0, **kw)
    init, end, rate, steps = opt.schedule("means")
    got = float(opt.learning_rate("means", torch.tensor(count, dtype=torch.int32)))
    if steps == 0:
        want = init
    else:
        value = init if count <= 0 else init * rate ** (count / steps)
        want = max(value, end) if rate < 1 else min(value, end)
    assert got == pytest.approx(want, rel=2e-6)
    assert opt.learning_rate("sh", torch.tensor(count)) == opt.schedule("sh")[0] == opt.sh_lr


def test_kernel_layout_is_the_wrappers():
    """csrc/adam.cu's AdamGroup holds _Group's fields in its order, and its
    constants are the wrapper's."""
    src = (pathlib.Path(adam.__file__).parents[1] / "csrc" / "adam.cu").read_text()
    body = re.search(r"struct AdamGroup \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"\b(\w+);", body)
    assert fields == [name for name, _ in adam._Group._fields_]
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kMaxGroups"]) == adam.MAX_GROUPS
    assert [int(consts[k]) for k in ("kConstant", "kDecayFloor", "kDecayCeiling")] == [
        adam.CONSTANT, adam.DECAY_FLOOR, adam.DECAY_CEILING]
    assert "adam" in adam._build.KERNELS
