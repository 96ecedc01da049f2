"""Checkpoints of a fleet: its carry and its generator.

The JAX package saves the fleet's carry after every report chunk, as
``.npz`` or Orbax (``mpc_rs_tpu/runtime/checkpoint.py``); its PRNG state
lives in the carry as per-scenario keys. The port's fleet draws from one
``torch.Generator``, whose state (a CUDA generator's: its seed and Philox
offset) is saved beside the carry, so a resumed fleet draws the noise the
uninterrupted one would have drawn. A checkpoint is one ``torch.save`` of
plain tensors, loaded with ``weights_only=True``. There is no Orbax.

``load_jax_fleet_npz`` carries a fleet across from a JAX ``fleet.npz``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mpc_rs_tpu_torch.estimators.ukf import UkfState
from mpc_rs_tpu_torch.parallel.scenario import ScenarioCarry, carry_from_numpy


def carry_fields(carry: ScenarioCarry) -> dict[str, torch.Tensor]:
    """The carry's tensors by name; ``ukf.sigma_f`` only under the AoS layout."""
    out = {"x": carry.x, "u_n": carry.u_n, "status": carry.status, "t": carry.t}
    out.update({f"ukf.{k}": v for k, v in carry.ukf._asdict().items() if v is not None})
    return out


def _carry(fields: dict[str, torch.Tensor]) -> ScenarioCarry:
    ukf = UkfState(*(fields.get(f"ukf.{k}") for k in UkfState._fields))
    return ScenarioCarry(x=fields["x"], u_n=fields["u_n"], ukf=ukf, status=fields["status"], t=fields["t"])


def _check_like(fields: dict[str, torch.Tensor], template: ScenarioCarry, what: str) -> None:
    """Refuse a checkpoint whose fields, shapes or dtypes are not the
    template's: another model, batch, horizon or estimator layout."""
    want = carry_fields(template)
    if set(fields) != set(want):
        raise ValueError(f"{what}: fields {sorted(fields)}, the fleet's are {sorted(want)} "
                         "(another estimator layout?)")
    for k, v in want.items():
        got = fields[k]
        if tuple(got.shape) != tuple(v.shape) or got.dtype != v.dtype:
            raise ValueError(f"{what}: {k} is {tuple(got.shape)} {got.dtype}, "
                             f"the fleet's is {tuple(v.shape)} {v.dtype}")


def save_fleet(path: str, carry: ScenarioCarry, generator: torch.Generator) -> None:
    """Write the carry and the generator's state to ``path`` atomically (a
    temporary file beside it, then ``os.replace``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {
        "carry": {k: v.detach().cpu() for k, v in carry_fields(carry).items()},
        "generator": generator.get_state(),
        "generator_device": generator.device.type,
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_fleet(path: str, template: ScenarioCarry, device) -> tuple[ScenarioCarry, torch.Generator]:
    """(carry, generator) of the checkpoint at ``path``, on ``device``:
    the carry's tensors, and a generator on ``device`` whose state is the
    saved one. Raises ValueError when the carry does not match
    ``template`` or the generator was saved on another device type."""
    device = torch.device(device)
    state = torch.load(path, map_location="cpu", weights_only=True)
    _check_like(state["carry"], template, path)
    if state["generator_device"] != device.type:
        raise ValueError(f"{path}: its generator was saved on {state['generator_device']}, "
                         f"not {device.type}; its state does not carry across")
    gen = torch.Generator(device=device)
    gen.set_state(state["generator"])
    return _carry({k: v.to(device) for k, v in state["carry"].items()}), gen


def load_jax_fleet_npz(path: str, ukf_layout: str, template: ScenarioCarry | None = None,
                       device=None) -> ScenarioCarry:
    """The carry of a JAX fleet's ``fleet.npz`` (``save_pytree``'s leaves
    ``leaf_0`` … in the order of the JAX ``ScenarioCarry``: x, u_n, ukf.x,
    ukf.p, ukf.q, ukf.r, [ukf.sigma_f under the AoS layout], key, status,
    t; ``mpc_rs_tpu/runtime/checkpoint.py:32-66``). The keys are dropped.
    With ``template`` the carry must match it field by field."""
    names = ["x", "u_n", "ukf.x", "ukf.p", "ukf.q", "ukf.r", *(["ukf.sigma_f"] if ukf_layout == "aos" else []),
             "key", "status", "t"]
    with np.load(path) as data:
        if len(data.files) != len(names):
            raise ValueError(f"{path}: {len(data.files)} leaves; a {ukf_layout} fleet carry has {len(names)}")
        leaves = dict(zip(names, (data[f"leaf_{i}"] for i in range(len(names)))))
    p_dims = 2 if ukf_layout == "soa" else 3
    if leaves["ukf.p"].ndim != p_dims:
        raise ValueError(f"{path}: ukf.p has {leaves['ukf.p'].ndim} dimensions, a {ukf_layout} carry's {p_dims}")
    ukf = {k[4:]: v for k, v in leaves.items() if k.startswith("ukf.")}
    carry = carry_from_numpy({"x": leaves["x"], "u_n": leaves["u_n"], "ukf": ukf, "key": leaves["key"],
                              "status": leaves["status"], "t": leaves["t"]}, device=device)
    if template is not None:
        _check_like(carry_fields(carry), template, path)
    return carry
