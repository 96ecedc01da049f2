"""Fleet checkpoints and ``--resume``: the port's ``fleet.pt`` round trip,
and a JAX ``fleet.npz`` carried across.

A fleet run for two report chunks and one run for a chunk, saved, resumed in
a fresh process state and run for one more chunk, end on the same carry and
generator state, bit for bit (the CPU here; ``chip_smoke.py`` on the card).
A ``fleet.npz`` that the JAX package's ``save_pytree`` writes from its
``ScenarioCarry`` loads through ``load_jax_fleet_npz`` field by field.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_rs_tpu.estimators.ukf import ukf_init as jukf_init
from mpc_rs_tpu.parallel.scenario import init_scenario_carry as jinit_carry
from mpc_rs_tpu.runtime.checkpoint import save_pytree
from mpc_rs_tpu_torch.apps import run as cli
from mpc_rs_tpu_torch.apps.fleet import build_fleet, resume_fleet, run_fleet
from mpc_rs_tpu_torch.runtime.checkpoint import carry_fields, load_fleet, load_jax_fleet_npz, save_fleet


def _assert_same_bits(a, b):
    fa, fb = carry_fields(a), carry_fields(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


@pytest.mark.parametrize("layout", ["soa", "aos"])
def test_cli_resume_equals_the_uninterrupted_run(layout, tmp_path):
    """Two chunks straight, against one chunk, ``--resume`` from its
    ``fleet.pt``, and one more chunk: the same carry and the same
    generator state (the noise drawn after the resume is the noise the
    uninterrupted run drew)."""
    common = ["fleet", "--device", "cpu", "--scenarios", "8", "--k", "256", "--report-every", "0.1",
              "--ukf-layout", layout]
    straight = cli.main([*common, "--t-end", "0.2", "--log-dir", str(tmp_path / "a")])
    cli.main([*common, "--t-end", "0.1", "--log-dir", str(tmp_path / "b")])
    resumed = cli.main([*common, "--t-end", "0.1", "--log-dir", str(tmp_path / "c"),
                        "--resume", str(tmp_path / "b" / "fleet" / "fleet.pt")])
    assert straight.ticks == 4 and resumed.ticks == 2
    _assert_same_bits(straight.carry, resumed.carry)
    template = build_fleet("cartpole4", 256, "cpu", scenarios=8, ukf_layout=layout).carry
    ca, ga = load_fleet(str(tmp_path / "a" / "fleet" / "fleet.pt"), template, "cpu")
    cc, gc = load_fleet(str(tmp_path / "c" / "fleet" / "fleet.pt"), template, "cpu")
    _assert_same_bits(ca, cc)
    _assert_same_bits(ca, straight.carry)
    assert torch.equal(ga.get_state(), gc.get_state())


def test_resume_on_the_chain(tmp_path):
    """The flagship fleet on the estimator chain (its plain version here):
    one chunk, save, a fresh fleet resumed, one more chunk, against two
    chunks straight."""
    def fleet():
        return build_fleet("flagship6", 2048, "cpu", scenarios=4, estimator_chain=True, seed=3)

    straight = run_fleet(fleet(), t_end=0.04, report_every=0.02)
    ckpt = str(tmp_path / "fleet.pt")
    run_fleet(fleet(), t_end=0.02, report_every=0.02, checkpoint=ckpt)
    resumed = run_fleet(resume_fleet(fleet(), ckpt, seed=99), t_end=0.02, report_every=0.02)
    _assert_same_bits(straight.carry, resumed.carry)


def test_load_fleet_refuses_another_fleet(tmp_path):
    fl = build_fleet("cartpole4", 256, "cpu", scenarios=8)
    path = str(tmp_path / "fleet.pt")
    save_fleet(path, fl.carry, fl.generator)
    assert [p.name for p in tmp_path.iterdir()] == ["fleet.pt"]  # no temporary file left
    with pytest.raises(ValueError, match="another estimator layout"):
        load_fleet(path, build_fleet("cartpole4", 256, "cpu", scenarios=8, ukf_layout="aos").carry, "cpu")
    with pytest.raises(ValueError, match=r"x is \(8, 4\)"):
        load_fleet(path, build_fleet("cartpole4", 256, "cpu", scenarios=16).carry, "cpu")
    with pytest.raises(ValueError, match="x is"):
        load_fleet(path, build_fleet("flagship6", 2048, "cpu", scenarios=8).carry, "cpu")
    carry, gen = load_fleet(path, fl.carry, "cpu")
    _assert_same_bits(carry, fl.carry)
    assert torch.equal(torch.randint(0, 2**31 - 1, (8,), generator=gen),
                       torch.randint(0, 2**31 - 1, (8,), generator=fl.generator))


def _jax_carry(layout, b=8):
    """A JAX cartpole4 fleet carry with every float field perturbed."""
    x0 = jnp.asarray([0.5, 0.0, 0.1, 0.0], jnp.float32)
    _, ukf0 = jukf_init(x0, 0.1 * jnp.eye(4, dtype=jnp.float32), 0.01 * jnp.eye(4, dtype=jnp.float32),
                        jnp.eye(3, dtype=jnp.float32))
    c = jinit_carry(b, x0, jnp.zeros(8, jnp.float32), ukf0, jax.random.key(0), ukf_layout=layout)
    rng = np.random.default_rng(5)
    bump = lambda a: jnp.asarray(np.asarray(a) + rng.normal(size=np.shape(a)).astype(np.float32))  # noqa: E731
    ukf = c.ukf._replace(x=bump(c.ukf.x), p=bump(c.ukf.p))
    return c._replace(x=bump(c.x), u_n=bump(c.u_n), ukf=ukf, t=bump(c.t),
                      status=jnp.asarray(rng.integers(0, 4, b), jnp.int32))


@pytest.mark.parametrize("layout", ["soa", "aos"])
def test_a_jax_fleet_npz_loads_field_by_field(layout, tmp_path):
    jc = _jax_carry(layout)
    path = str(tmp_path / "fleet.npz")
    save_pytree(path, jc)
    got = load_jax_fleet_npz(path, layout)
    want = {"x": jc.x, "u_n": jc.u_n, "status": jc.status, "t": jc.t, "ukf.x": jc.ukf.x, "ukf.p": jc.ukf.p,
            "ukf.q": jc.ukf.q, "ukf.r": jc.ukf.r}
    if layout == "aos":
        want["ukf.sigma_f"] = jc.ukf.sigma_f
    fields = carry_fields(got)
    assert set(fields) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(fields[k].numpy(), np.asarray(v), err_msg=k)
        assert fields[k].dtype == torch.from_numpy(np.array(v)).dtype, k
    other = "aos" if layout == "soa" else "soa"
    with pytest.raises(ValueError):
        load_jax_fleet_npz(path, other)


def test_cli_resumes_from_a_jax_fleet_npz(tmp_path, capsys):
    path = str(tmp_path / "fleet.npz")
    save_pytree(path, _jax_carry("soa")._replace(status=jnp.zeros(8, jnp.int32)))
    res = cli.main(["fleet", "--device", "cpu", "--scenarios", "8", "--k", "256", "--t-end", "0.1",
                    "--report-every", "0.1", "--seed", "4", "--resume", path, "--log-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "its PRNG keys are dropped; the generator is seeded from --seed 4" in out
    assert f"checkpoint: {tmp_path / 'fleet' / 'fleet.pt'}" in out
    np.testing.assert_allclose(res.carry.t.numpy(), np.asarray(_jax_carry("soa").t) + 0.1, rtol=1e-6)
    with pytest.raises(ValueError, match="x is"):
        cli.main(["fleet", "--device", "cpu", "--scenarios", "16", "--k", "256", "--t-end", "0.05",
                  "--resume", path, "--log-dir", str(tmp_path)])
