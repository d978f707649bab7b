"""A recording stand-in for `viser` and `viser.transforms` where viser is not
installed (the CPU tests, chip_smoke.py):

    calls = viser_stub.install(sys.modules)
    calls = viser_stub.install_with(monkeypatch)    # in a test

Every server, GUI and scene call is appended to `calls` as (name, args,
kwargs). `install_with` also makes both packages' viewer modules import
afresh, and the monkeypatch undoes it. SE3.from_matrix gives a (3, 4) [R |
t]'s (w, x, y, z) quaternion and translation.
"""
from __future__ import annotations

import types

import numpy as np


class _Handle:
    def __init__(self, value=None):
        self.value = value
        self.visible = True

    def on_update(self, fn):
        self.callback = fn
        return fn


class _Recorder:
    def __init__(self, calls, prefix):
        self._calls = calls
        self._prefix = prefix

    def __getattr__(self, name):
        def call(*args, **kwargs):
            self._calls.append((f"{self._prefix}.{name}", args, kwargs))
            return _Handle(kwargs.get("initial_value"))
        return call


class _SE3:
    def __init__(self, wxyz, t):
        self.wxyz = wxyz
        self._t = t

    @classmethod
    def from_matrix(cls, m):
        m = np.asarray(m, np.float64)
        R, t = m[:3, :3], m[:3, 3]
        w = np.sqrt(max(0.0, 1.0 + np.trace(R))) / 2
        x = np.copysign(np.sqrt(max(0.0, 1 + R[0, 0] - R[1, 1] - R[2, 2])) / 2,
                        R[2, 1] - R[1, 2])
        y = np.copysign(np.sqrt(max(0.0, 1 - R[0, 0] + R[1, 1] - R[2, 2])) / 2,
                        R[0, 2] - R[2, 0])
        z = np.copysign(np.sqrt(max(0.0, 1 - R[0, 0] - R[1, 1] + R[2, 2])) / 2,
                        R[1, 0] - R[0, 1])
        return cls(np.array([w, x, y, z]), t.copy())

    def rotation(self):
        return self

    def translation(self):
        return self._t


def install(modules) -> list:
    """Put fresh `viser` and `viser.transforms` stubs into `modules` (a
    dict such as sys.modules); return the list their calls go to."""
    calls: list = []

    class ViserServer:
        def __init__(self, *args, **kwargs):
            calls.append(("ViserServer", args, kwargs))
            self.gui = _Recorder(calls, "gui")
            self.scene = _Recorder(calls, "scene")

    viser = types.ModuleType("viser")
    transforms = types.ModuleType("viser.transforms")
    viser.ViserServer = ViserServer
    transforms.SE3 = _SE3
    viser.transforms = transforms
    modules["viser"] = viser
    modules["viser.transforms"] = transforms
    return calls


VIEWER_MODULES = ("vggt_slam_tpu.viz.viser_viewer",
                  "vggt_slam_tpu_torch.viz.viser_viewer")


def install_with(monkeypatch, present: bool = True) -> list:
    """install() through `monkeypatch`; present=False hides viser instead
    (its import raises ImportError)."""
    import sys

    stub: dict = {}
    calls = install(stub)
    for name in stub:
        monkeypatch.setitem(sys.modules, name, stub[name] if present else None)
    for name in VIEWER_MODULES:     # absent now, as before once undone
        monkeypatch.setitem(sys.modules, name, None)
        monkeypatch.delitem(sys.modules, name)
    return calls
