"""The fused and K-blocked ticks of the port against the JAX Pallas kernels.

* injected ε: the port's ``make_cuda_diffdrive_tick(fuse_epilogue=True)``
  through its ``mppi_step`` against ``make_pallas_diffdrive_tick(interpret=
  True, fuse_epilogue=True)`` through the JAX one, at the tolerances of
  tests/test_mppi_tick.py:121-130 (S rtol/atol 2e-4, w rtol 2e-4 atol 1e-6,
  controls rtol 1e-4 atol 1e-5);
* hash ε: the port's K-blocked tick against
  ``diffdrive_mppi_tick_blocked(gaussian="hash", interpret=True)`` — the
  same noise stream bit for bit, so S agrees to float32 rounding (rtol 2e-5,
  atol 2e-4 as tests/test_mppi_tick_blocked.py:314) and ρ, η, w·ε to the
  reductions' order (rtol 1e-4, atol 1e-5 as its :189-193).

On the CPU the port runs the kernels' plain versions; the kernels are held
against them on the card (marked ``cuda``).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_mppi_mpc_tpu import config as jcfg
from dnn_mppi_mpc_tpu.models.dynamics import unicycle as j_unicycle
from dnn_mppi_mpc_tpu.models.integrators import euler_step as j_euler
from dnn_mppi_mpc_tpu.ops.pallas.mppi_tick_blocked import diffdrive_mppi_tick_blocked as j_blocked
from dnn_mppi_mpc_tpu.ops.sampling import sigma_inverse as j_sigma_inverse
from dnn_mppi_mpc_tpu.ops.sampling import small_cholesky as j_small_cholesky
from dnn_mppi_mpc_tpu.solvers import mppi as jmppi
from dnn_mppi_mpc_tpu_torch import config as tcfg
from dnn_mppi_mpc_tpu_torch.models import euler_step, unicycle
from dnn_mppi_mpc_tpu_torch.ops.cuda import mppi_tick as ttick
from dnn_mppi_mpc_tpu_torch.ops.cuda import mppi_tick_blocked as tblocked
from dnn_mppi_mpc_tpu_torch.solvers import mppi as tmppi

DT = 0.05


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _path(n=40):
    return np.stack(
        [np.linspace(0, 4, n), np.sin(np.linspace(0, 2, n)), np.linspace(0.1, 0.5, n)], 1
    ).astype(np.float32)


def _params(obstacles=None, velocities=None, control_weight=None, sym=True):
    return dict(
        sigma=np.array([[0.2, 0.05], [0.05, 0.1]], np.float32),
        stage_weight=np.array([4.0, 4.0 if sym else 2.0, 0.5], np.float32),
        terminal_weight=np.array([9.0, 9.0, 2.0], np.float32),
        u_min=np.array([-1.5, -2.0], np.float32),
        u_max=np.array([1.5, 2.0], np.float32),
        ref_path=_path(),
        obstacles=None if obstacles is None else np.asarray(obstacles, np.float32),
        obstacle_velocities=None if velocities is None else np.asarray(velocities, np.float32),
        control_weight=None if control_weight is None else np.asarray(control_weight, np.float32),
    )


def _both(K, T, W, params_np, collision, accumulation="sum", **cfg_kw):
    """(jax side, port side) of one problem: cfg, params, step, stage, terminal."""
    kw = dict(num_samples=K, horizon=T, dim_x=3, dim_u=2, dt=DT, lam=0.8, alpha=0.3,
              exploration=0.2, filter_window=5, waypoint_search_len=W, **cfg_kw)
    jc = jcfg.MPPIConfig(**kw, accumulation=jcfg.CostAccumulation(accumulation))
    tc = tcfg.MPPIConfig(**kw, accumulation=tcfg.CostAccumulation(accumulation))
    jp = jcfg.MPPIParams(**{k: None if v is None else jnp.asarray(v) for k, v in params_np.items()})
    tp = tcfg.params_from_numpy(**params_np)
    js, jt = jmppi.make_tracking_costs(jc, collision=collision)
    ts, tt = tmppi.make_tracking_costs(tc, collision=collision)
    jside = (jc, jp, lambda x, u: j_euler(j_unicycle, x, u, DT), js, jt)
    tside = (tc, tp, lambda x, u: euler_step(unicycle, x, u, DT), ts, tt)
    return jside, tside


def _noise(K, T, sigma, seed):
    rng = np.random.default_rng(seed)
    return rng.multivariate_normal(np.zeros(2), sigma, (K, T)).astype(np.float32)


def _tick_both(jside, tside, *, x0, u_prev, eps, collision, iso_xy, fuse=True):
    jc, jp, jstep, js, jt = jside
    tc, tp, tstep, ts, tt = tside
    jtick = jmppi.make_pallas_diffdrive_tick(
        jc, robot_radius=0.5, interpret=True, fuse_epilogue=fuse, iso_xy=iso_xy,
        collision=collision if collision != "none" else "circle",
    )
    ttick_fn = tmppi.make_cuda_diffdrive_tick(
        tc, 0.5, fuse_epilogue=fuse, iso_xy=iso_xy,
        collision=collision if collision != "none" else "circle",
    )
    jstate = jmppi.MPPIState(
        u_prev=jnp.asarray(u_prev), waypoint_idx=jnp.zeros((), jnp.int32),
        key=jnp.asarray([5, 9], jnp.uint32),
    )
    tstate = tmppi.state_from_numpy(u_prev, 0, [5, 9])
    jout = jax.jit(
        lambda p, s, x, n: jmppi.mppi_step(jc, jstep, js, jt, p, s, x, n, tick_fn=jtick)
    )(jp, jstate, jnp.asarray(x0), jnp.asarray(eps))
    tout = tmppi.mppi_step(
        tc, tstep, ts, tt, tp, tstate, torch.as_tensor(x0), torch.as_tensor(eps),
        tick_fn=ttick_fn,
    )
    return jout, tout


def _assert_tick_close(jout, tout):
    (ju0, jst, jaux), (tu0, tst, taux) = jout, tout
    np.testing.assert_allclose(taux.costs.numpy(), np.asarray(jaux.costs), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(taux.weights.numpy(), np.asarray(jaux.weights), rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(tu0.numpy(), np.asarray(ju0), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tst.u_prev.numpy(), np.asarray(jst.u_prev), rtol=1e-4, atol=1e-5)
    assert int(tst.waypoint_idx) == int(jst.waypoint_idx)
    assert int(taux.status) == int(jaux.status)
    assert tst.key.tolist() == np.asarray(jax.random.key_data(jst.key)
                                          if jnp.issubdtype(jst.key.dtype, jax.dtypes.prng_key)
                                          else jst.key).astype(np.int64).tolist()


TICK_CASES = {
    "plain": dict(collision="none", iso_xy=False),
    "iso_xy": dict(collision="none", iso_xy=True),
    "circle_iso": dict(collision="circle", iso_xy=True,
                       params=dict(obstacles=[[1.0, 0.4, 0.3], [2.5, 0.8, 0.4]])),
    "circle_drift": dict(collision="circle", iso_xy=False,
                         params=dict(obstacles=[[1.0, 0.4, 0.3], [2.5, 0.8, 0.4]],
                                     velocities=[[0.8, -0.5], [-0.6, 0.4]])),
    "soft_drift": dict(collision="soft", iso_xy=False,
                       params=dict(obstacles=[[1.2, 0.9, 0.3], [2.2, 1.6, 0.4]],
                                   velocities=[[0.5, 0.3], [-0.4, 0.2]])),
    "control_weight": dict(collision="none", iso_xy=False,
                           params=dict(control_weight=[0.1, 0.1])),
    "last_asym": dict(collision="none", iso_xy=False, accumulation="last",
                      params=dict(sym=False)),
    "unfused_epilogue": dict(collision="circle", iso_xy=False, fuse=False,
                             params=dict(obstacles=[[1.0, 0.4, 0.3]])),
}


@pytest.mark.parametrize("case", list(TICK_CASES))
def test_fused_tick_injected_matches_jax(case):
    spec = TICK_CASES[case]
    K, T, W = 512, 12, 8
    jside, tside = _both(K, T, W, _params(**spec.get("params", {})), spec["collision"],
                         accumulation=spec.get("accumulation", "sum"))
    eps = _noise(K, T, np.asarray(jside[1].sigma), seed=3)
    u_prev = np.random.default_rng(0).normal(0, 0.3, (T, 2)).astype(np.float32)
    jout, tout = _tick_both(
        jside, tside, x0=np.array([0.1, -0.05, 0.2], np.float32), u_prev=u_prev, eps=eps,
        collision=spec["collision"], iso_xy=spec["iso_xy"], fuse=spec.get("fuse", True),
    )
    _assert_tick_close(jout, tout)


def test_fused_tick_nonfinite_holds_previous_like_jax():
    K, T, W = 512, 12, 8
    jside, tside = _both(K, T, W, _params(), "none")
    eps = _noise(K, T, np.asarray(jside[1].sigma), seed=9)
    eps[0, 0, 0] = np.nan
    u_prev = np.random.default_rng(1).normal(0, 0.3, (T, 2)).astype(np.float32)
    jout, tout = _tick_both(jside, tside, x0=np.array([0.1, -0.05, 0.2], np.float32),
                            u_prev=u_prev, eps=eps, collision="none", iso_xy=False)
    (_, jst, jaux), (_, tst, taux) = jout, tout
    assert int(taux.status) & 2 and int(taux.status) == int(jaux.status)
    want = np.concatenate([u_prev[1:], u_prev[-1:]])
    np.testing.assert_array_equal(tst.u_prev.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jst.u_prev), want)


# --- hash ε: the K-blocked stream ---------------------------------------

KB_K, KB_T, KB_W, KB_BLK = 2048, 20, 8, 1024


def _blocked_inputs(iso_obstacles):
    params = _params(obstacles=[[1.5, 0.5, 0.3]] if iso_obstacles != "soft" else
                     [[1.2, 0.9, 0.3], [2.2, 1.6, 0.4]],
                     velocities=[[0.5, 0.3], [-0.4, 0.2]] if iso_obstacles == "soft" else None)
    rng = np.random.default_rng(0)
    u = rng.normal(0, 0.3, (KB_T, 2)).astype(np.float32)
    a = (0.8 * 0.7 * (u @ np.asarray(j_sigma_inverse(jnp.asarray(params["sigma"]))))
         ).astype(np.float32)
    return dict(
        u=u, a=a,
        chol_sigma=np.asarray(j_small_cholesky(jnp.asarray(params["sigma"]))).astype(np.float32),
        x0=np.array([0.0, 0.0, 0.2], np.float32),
        window=params["ref_path"][:KB_W],
        stage_w=params["stage_weight"], term_w=params["terminal_weight"],
        u_min=params["u_min"], u_max=params["u_max"],
        obstacles=params["obstacles"], obstacle_velocities=params["obstacle_velocities"],
    )


def _blocked_both(inputs, *, K_BLK, iso_xy, collision, seed=1234, inv_temperature=1.25):
    common = dict(robot_radius=0.5, K=KB_K, T=KB_T, W=KB_W, K_BLK=K_BLK,
                  iso_xy=iso_xy, collision=collision)
    order = ["u", "a", "chol_sigma", "x0", "window", "stage_w", "term_w", "u_min", "u_max"]
    extra = dict(obstacles=inputs["obstacles"], obstacle_velocities=inputs["obstacle_velocities"])
    n_exploit = 0.8 * KB_K
    j = j_blocked(
        jnp.asarray(seed, jnp.int32), *(jnp.asarray(inputs[k]) for k in order), DT, n_exploit,
        inv_temperature,
        **{k: None if v is None else jnp.asarray(v) for k, v in extra.items()},
        gaussian="hash", interpret=True, **common,
    )
    t = tblocked.diffdrive_mppi_tick_blocked(
        torch.tensor([seed]), *(torch.as_tensor(inputs[k]) for k in order), DT, n_exploit,
        inv_temperature, **{k: None if v is None else torch.as_tensor(v) for k, v in extra.items()},
        **common,
    )
    return [np.asarray(v) for v in j], [v.numpy() for v in t]


def _assert_blocked_close(j, t):
    (jS, jrho, jeta, jweps), (tS, trho, teta, tweps) = j, t
    np.testing.assert_allclose(tS, jS, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(trho, jrho, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(teta, jeta, rtol=1e-4)
    np.testing.assert_allclose(tweps, jweps, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "iso_xy, collision", [(False, "circle"), (True, "circle"), (False, "soft")],
    ids=["circle", "circle_iso", "soft_drift"],
)
def test_blocked_tick_hash_matches_jax(f32_mode, iso_xy, collision):
    inputs = _blocked_inputs("soft" if collision == "soft" else "circle")
    j, t = _blocked_both(inputs, K_BLK=KB_BLK, iso_xy=iso_xy, collision=collision)
    _assert_blocked_close(j, t)


def test_fused_tick_hash_stream_is_the_single_block_stream(f32_mode):
    """The fused tick's generated ε is the blocked stream with K_BLK = K: its
    S and Σw·ε equal the JAX blocked kernel's at one block."""
    inputs = _blocked_inputs("circle")
    j, _ = _blocked_both(inputs, K_BLK=KB_K, iso_xy=False, collision="circle")
    S, w, w_eps = ttick.diffdrive_mppi_tick(
        torch.tensor([1234]), *(torch.as_tensor(inputs[k]) for k in
                               ["u", "a", "chol_sigma", "x0", "window", "stage_w", "term_w",
                                "u_min", "u_max"]),
        DT, 0.8 * KB_K, 1.25, obstacles=torch.as_tensor(inputs["obstacles"]),
        K=KB_K, T=KB_T, W=KB_W,
    )
    np.testing.assert_allclose(S.numpy(), j[0], rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(w_eps.numpy(), j[3], rtol=1e-4, atol=1e-5)


def test_blocked_binder_rejects_injected_noise():
    K, T, W = 2048, 12, 8
    _, tside = _both(K, T, W, _params(), "none")
    tc, tp, tstep, ts, tt = tside
    tick = tmppi.make_cuda_diffdrive_tick_blocked(tc, k_block=1024)
    with pytest.raises(ValueError, match="PRNG-mode only"):
        tmppi.mppi_step(tc, tstep, ts, tt, tp, tmppi.MPPIState.init(tc), torch.zeros(3),
                        torch.zeros(K, T, 2), tick_fn=tick)


@pytest.mark.cuda
def test_tick_kernels_match_plain_on_card(cuda_device):
    inputs = _blocked_inputs("soft")
    args = [torch.as_tensor(inputs[k], device=cuda_device) for k in
            ["u", "a", "chol_sigma", "x0", "window", "stage_w", "term_w", "u_min", "u_max"]]
    kw = dict(obstacles=torch.as_tensor(inputs["obstacles"], device=cuda_device),
              obstacle_velocities=torch.as_tensor(inputs["obstacle_velocities"],
                                                  device=cuda_device),
              collision="soft", K=KB_K, T=KB_T, W=KB_W)
    seed = torch.tensor([77], device=cuda_device)
    got = ttick.diffdrive_mppi_tick(seed, *args, DT, 0.8 * KB_K, 1.25, **kw)
    want = ttick.diffdrive_mppi_tick_plain(seed, *args, DT, 0.8 * KB_K, 1.25, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    got = tblocked.diffdrive_mppi_tick_blocked(seed, *args, DT, 0.8 * KB_K, 1.25,
                                               K_BLK=KB_BLK, **kw)
    want = tblocked.diffdrive_mppi_tick_blocked_plain(seed, *args, DT, 0.8 * KB_K, 1.25,
                                                      K_BLK=KB_BLK, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
