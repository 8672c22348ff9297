"""The check's control at a size a test run holds: the reference in
bfloat16, put in the port's place, fails the limits of the cells it stands
for, while the port passes them. On the CPU here; on the card (marked
``card``) at a larger size, as ``python3 -m splatbench.calibrate`` reads it
at the cells' own sizes."""

import json
import os

import pytest
import torch

from conftest import ROOT
from splatbench import drive

HERE = os.path.join(ROOT, "splatbench")
SIZES = dict(cpu=dict(gaussians=2000, width=64, height=48, views=6, scale_range=[0.02, 0.2]),
             cuda=dict(gaussians=100_000, width=800, height=800, views=8,
                       scale_range=[0.004, 0.04]))


def load(*parts):
    return json.load(open(os.path.join(HERE, *parts)))


def mix_of(cell, device, seed):
    conf = dict(load("configs", "garden.json"), **SIZES[device.type])
    traffic = load("traffic", f"{cell.split('-')[1]}.json")
    if "orbit" in traffic:
        traffic["orbit"] = dict(traffic["orbit"], poses_per_rev=12)
    run = drive.Run(conf=conf, traffic=traffic, seed=seed, seconds=0.3, traced=False,
                    device=device)
    return drive.load_kind(traffic["kind"])(run)


def readings(cell, device, seed):
    mix = mix_of(cell, device, seed)
    mix.setup()
    if mix.run.traffic["kind"] == "view":
        mix.window()
    mix.free()
    ref = mix.check()
    return mix.readings(ref), mix.compare(mix.check(torch.bfloat16), ref)


def failed(values, limits):
    return [k for k, v in values.items() if not v <= limits[k]]


@pytest.mark.parametrize("cell", ["garden-train", "garden-view"])
def test_control_fails_and_port_passes_cpu(cell):
    program, control = readings(cell, torch.device("cpu"), 2**31 + 11)
    limits = load("limits", f"{cell}.json")
    assert not failed(program, limits), program
    assert failed(control, limits), control


@pytest.mark.card
@pytest.mark.parametrize("cell", ["garden-train", "garden-view"])
def test_control_fails_and_port_passes_card(card, cell):
    for seed in (2**31 + 21, 2**31 + 22, 2**31 + 23):
        program, control = readings(cell, card, seed)
        limits = load("limits", f"{cell}.json")
        assert not failed(program, limits), (seed, program)
        assert failed(control, limits), (seed, control)
