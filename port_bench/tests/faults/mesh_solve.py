"""Faults planted under the mesh solve's timed path (``entries/mesh_solve.py``):
the general model's solve."""


def install(monkeypatch, fault):
    from wave_fenics_tpu_torch.models.general_wave import GeneralLinearWave

    orig = GeneralLinearWave.solve_n

    def broken(self, t0, dt, nsteps, u0=None, v0=None, integrator="rk4"):
        if fault == "unchanged":  # a step that returns its state unchanged
            return u0.clone(), v0.clone()
        u, v = orig(self, t0, dt, nsteps, u0, v0, integrator)
        u = u.clone()
        u.view(-1)[u.abs().argmax()] *= 1.1  # one answer altered where produced
        return u, v

    monkeypatch.setattr(GeneralLinearWave, "solve_n", broken)
