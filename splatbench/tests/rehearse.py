"""Drive one cell through the harness on the CPU, at whatever size the
checkout's files give it, with the timed path optionally broken underneath,
and print the result line. The harness's own tests run it in a temporary
copy of the benchmark that holds tiny cells.

    python3 rehearse.py ROOT WORKLOAD SEED SECONDS TRACE [FAULT]

FAULT breaks the port where it produces its answer: ``unchanged`` (a
training step returns its state as it was; a frame is the one drawn
before), ``half_batch`` (the loss over the left half of the image alone;
a frame's lower half left black), ``altered`` (0.1 added to the first
tile of the image the loss sees, or of the frame drawn).
"""

import functools
import json
import sys

root, workload, seed, seconds, traced = sys.argv[1:6]
fault = sys.argv[6] if len(sys.argv) > 6 else None
sys.path.insert(0, root)

import torch  # noqa: E402

torch.set_num_threads(1)


def patch(fault):
    import tpusplat_torch.train.step as step
    from tpusplat_torch import session

    real_step, real_draw = step.train_step, session.Session.draw
    if fault == "unchanged":
        @functools.wraps(real_step)  # the compiled step binds the real signature
        def train_step(state, *a, **k):
            return state, real_step(state, *a, **k)[1]

        last = {}

        def draw(self):
            img, aux = real_draw(self)
            prev = last.get("img", img)
            last["img"] = img
            return prev, aux
    elif fault == "half_batch":
        real_loss = step.gs_loss

        def gs_loss(img, target, w=0.2):
            half = img.shape[1] // 2
            return real_loss(img[:, :half], target[:, :half], w)

        step.gs_loss = gs_loss

        def draw(self):
            img, aux = real_draw(self)
            img = img.clone()
            img[img.shape[0] // 2:] = 0.0
            return img, aux
        train_step = real_step
    elif fault == "altered":
        real_render = step.render_stages

        def render_stages(*a, **k):
            img, aux = real_render(*a, **k)
            return img + torch.nn.functional.pad(
                torch.full((16, 16, 3), 0.1), (0, 0, 0, img.shape[1] - 16, 0,
                                               img.shape[0] - 16)), aux

        step.render_stages = render_stages

        def draw(self):
            img, aux = real_draw(self)
            img = img.clone()
            img[:16, :16] += 0.1
            return img, aux
        train_step = real_step
    else:
        raise SystemExit(f"unknown fault {fault!r}")
    step.train_step = train_step
    session.Session.draw = draw


if fault:
    patch(fault)

from splatbench import run  # noqa: E402

out = run.execute(workload, int(seed), float(seconds), bool(int(traced)), device="cpu")
print(json.dumps(out))
