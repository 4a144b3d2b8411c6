"""Faults planted under the box solve's timed path (``entries/box_solve.py``):
the padded model's RK4 and leapfrog solves."""


def install(monkeypatch, fault):
    from wave_fenics_tpu_torch.models.linear_wave_padded import PaddedLinearWave

    for name in ("solve_step_n", "solve_lf2_n"):
        orig = getattr(PaddedLinearWave, name)

        def broken(self, t0, dt, n, u0=None, v0=None, _orig=orig):
            if fault == "unchanged":  # a step that returns its state unchanged
                return u0.clone(), v0.clone(), n
            u, v, n = _orig(self, t0, dt, n, u0, v0)
            u = u.clone()
            u.view(-1)[u.abs().argmax()] *= 1.1  # one answer altered where produced
            return u, v, n

        monkeypatch.setattr(PaddedLinearWave, name, broken)
