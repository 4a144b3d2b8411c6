"""Faults planted under BP1 CG's timed path (``entries/cg_solve.py``): the
port's CG solver."""

import torch


def install(monkeypatch, fault):
    from wave_fenics_tpu_torch.solvers import cg as cg_mod

    orig = cg_mod.cg

    def broken(matvec, b, **kw):
        if fault == "unchanged":
            return torch.zeros_like(b), kw["kmax"], torch.zeros(())
        x, k, r = orig(matvec, b, **kw)
        x = x.clone()
        x.view(-1)[x.abs().argmax()] *= 1.1
        return x, k, r

    monkeypatch.setattr(cg_mod, "cg", broken)
