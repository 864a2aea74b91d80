"""diamond_tpu_torch's static int8 rollout against diamond_tpu's (tpu.int8_rollout with
tpu.int8_sites), float32 on the CPU, same weights, inputs and draws: the int8 branches
of each site module, calibration of the denoiser and the rew/end model, the structural
int8 gate, the quant collection through the weight bridge, and the whole int8 rollout at
B=4, 4 steps, both ICPool.feats branches, with the default sites and with every site.

JAX's ``DiffusionSampler.calibrate`` draws its own x_init, so the JAX side of the
calibration test runs its observe pass by hand (``quant.calibration_scope`` around
``sample(..., x_init=x)``, then ``registry_to_collection``); the port's ``calibrate``
takes the same x_init.

Tolerances. One site module on the same inputs: 1e-5 of max |y| (the int8 sums are
exact on both sides). Calibrated act_scale to rtol 1e-5 (maxima of activations that
differ by f32 rounding); w_q equal in at least 99.9 % of entries and within 1 elsewhere
(a scale one ulp apart can move a round-half case). The rollout: actions, rewards, ends,
truncations and the pool pointer exactly, logits and values to rtol = atol = 1e-3, as
tests/test_torch_rollout.py holds the f32 rollout. States and frames cannot be held to
that file's 1e-3 and one-grid-level bounds: the two frameworks' f32 results differ in
the last ulp (sin/cos of the noise embedding, matmul and reduction orders), a value one
ulp from a rounding boundary lands on the other int8 code, and a flipped code moves the
next layers' inputs by a whole quantization step, so flips cascade through the U-Net and
the autoregressive rollout. Their yardstick is the quantization error itself: the port's
disagreement with the JAX int8 rollout stays within the JAX int8 rollout's own distance
from the JAX f32 rollout on the same draws (every LSTM state's max difference, the
largest frame difference in grid levels and the share of pixels that differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diamond_tpu.data.episode import obs_to_float as j_obs_to_float
from diamond_tpu.envs import world_model_env as jwm
from diamond_tpu.models import blocks as jb
from diamond_tpu.models.lstm import LSTM as JLSTM
from diamond_tpu.ops import quant as jquant
from diamond_tpu_torch.envs.world_model_env import ICPool, encode_pool_feats, make_ic_preparer
from diamond_tpu_torch.interop.jax_vars import load_variables, module_to_variables
from diamond_tpu_torch.models import blocks as tb
from diamond_tpu_torch.models.lstm import LSTM
from diamond_tpu_torch.ops import quant

from test_torch_rollout import B, T, engines, jax_draws  # noqa: F401 (engines: fixture)
from torch_port_util import close, jax_and_port, t

SITES = ["conv3x3,conv1x1", "all"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(coll):
    """{dotted path: numpy array} of a nested collection (JAX or port)."""
    flat = jax.tree_util.tree_flatten_with_path(_np(coll))[0]
    return {".".join(str(getattr(k, "key", k)) for k in p): v for p, v in flat}


def assert_collections_close(port, ref):
    lp, lr = _leaves(port), _leaves(ref)
    assert sorted(lp) == sorted(lr)
    for k, r in lr.items():
        p = lp[k]
        assert p.dtype == r.dtype and p.shape == r.shape, k
        if k.endswith("w_q"):
            d = np.abs(p.astype(np.int32) - r.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (k, d.max(), (d > 0).mean())
        else:
            np.testing.assert_allclose(p, r, rtol=1e-5, atol=0, err_msg=k)


def _conditioning(e, idx):
    """Float conditioning frames (B, n_cond, H, W, C) and actions of pool entries idx."""
    return e["obs"][idx], e["act"][idx]


@pytest.fixture(autouse=True)
def unquantized(engines):  # noqa: F811
    """Every test leaves the shared port models without a collection."""
    yield
    quant.strip(engines["p"].denoiser.inner_model)
    quant.strip(engines["p"].rew_end_model.net)


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * 2).astype(np.float32) for s in shapes]


SITE_MODULES = {
    "conv3x3": lambda: (jb.Conv3x3(16, jnp.float32), tb.Conv3x3(32, 16), (2, 8, 8, 32)),
    "conv3x3_stride2": lambda: (jb.Conv3x3(16, jnp.float32, strides=2),
                                tb.Conv3x3(32, 16, strides=2), (2, 9, 9, 32)),
    "conv3x3_cin6": lambda: (jb.Conv3x3(32, jnp.float32), tb.Conv3x3(6, 32), (2, 8, 8, 6)),
    "conv1x1": lambda: (jb.Conv1x1(48, jnp.float32), tb.Conv1x1(32, 48), (2, 8, 8, 32)),
    "dense": lambda: (jb.QDense(24, jnp.float32), tb.QDense(32, 24), (20, 32)),
    "resblock": lambda: (jb.ResBlock(32, False), tb.ResBlock(32, 32, 16, False),
                         (2, 8, 8, 32), (2, 16)),
    "resblock_proj": lambda: (jb.ResBlock(32, False), tb.ResBlock(64, 32, 16, False),
                              (2, 8, 8, 64), (2, 16)),
    "lstm": lambda: (JLSTM(32), LSTM(48, 32), (3, 2, 48), (3, 32), (3, 32)),
}


@pytest.mark.parametrize("name", list(SITE_MODULES))
def test_site_module_int8_branch_matches_jax(name):
    """Each site module's three cases against its flax twin: calibrating (same ranges,
    unquantized output), quantized with the JAX collection (the ResBlocks through K4's
    fused norm -> conv codes), and outside the int8 scope (unquantized)."""
    jm, pm, *shapes = SITE_MODULES[name]()
    args = _inputs(1, *shapes)
    if name == "lstm":
        args = [args[0], (args[1] * 0.25, args[2])]
    v, m = jax_and_port(jm, pm, 2, *args)
    targs = [tuple(map(t, a)) if isinstance(a, tuple) else t(a) for a in args]
    registry = {}
    with jquant.int8_rollout_scope(True), jquant.calibration_scope(registry):
        jm.apply(v, *args)
    coll_j = jquant.registry_to_collection(registry)
    reg_p = {}
    with torch.no_grad(), quant.int8_scope(True), quant.calibration_scope(reg_p, m):
        y_cal = m(*targs)
    assert_collections_close(quant.registry_to_collection(reg_p), coll_j)

    vq = dict(v, quant=coll_j)
    load_variables(m, _np(vq))
    with jquant.int8_rollout_scope(True):
        y_j = jm.apply(vq, *args)
    y_f = jm.apply(v, *args)
    with torch.no_grad():
        with quant.int8_scope(True):
            y_p = m(*targs)
        y_out = m(*targs)
    first = lambda y: y[0] if isinstance(y, tuple) else y  # noqa: E731
    y_j, y_p, y_f, y_out, y_cal = (np.asarray(first(y))
                                   for y in (y_j, y_p, y_f, y_out, y_cal))
    assert not np.array_equal(y_j, y_f), "the int8 branch must change the output"
    assert np.abs(y_p - y_j).max() <= 1e-5 * np.abs(y_j).max()
    close(y_out, y_f, 1e-4, 1e-4)  # outside the scope the collection changes nothing
    close(y_cal, y_f, 1e-4, 1e-4)  # calibrating runs the unquantized path


@pytest.mark.parametrize("sites", SITES)
def test_denoiser_calibration_matches_jax(engines, sites):  # noqa: F811
    e = engines
    _, d_vars, _ = e["vars"]
    obs_u8, act = _conditioning(e, np.arange(B))
    obs_f = np.asarray(j_obs_to_float(jnp.asarray(obs_u8)))
    x_init = np.random.default_rng(20).normal(size=(B,) + obs_u8.shape[2:]).astype(np.float32)

    def observe(v, prev_obs, prev_act, x):
        registry: dict = {}
        with jquant.calibration_scope(registry):
            e["j"].sampler.sample(v, jax.random.PRNGKey(0), prev_obs, prev_act, x_init=x)
        return jquant.registry_to_collection(registry, jquant.parse_sites(sites))

    ref = jax.jit(observe)(d_vars, obs_f, act, x_init)
    with torch.no_grad():
        coll = e["p"].sampler.calibrate(t(obs_f), t(act), sites, x_init=t(x_init))
    assert "conv_in" not in coll and "conv_out" in coll  # the split conv_in is no site
    assert_collections_close(coll, ref)


@pytest.mark.parametrize("sites", SITES)
def test_rew_end_calibration_matches_jax(engines, sites):  # noqa: F811
    e = engines
    _, _, r_vars = e["vars"]
    obs = np.asarray(j_obs_to_float(jnp.asarray(e["obs"][:B])))
    act = e["act"][:B]
    ref = e["j"].rew_end_model.calibrate(r_vars, obs[:, -2:-1], act[:, -2:-1], obs[:, -1:],
                                         sites=sites)["quant"]
    coll = e["p"].rew_end_model.calibrate(t(obs[:, -2:-1]), t(act[:, -2:-1]), t(obs[:, -1:]),
                                          sites)
    assert ("lstm" in coll) == (sites == "all")
    assert_collections_close(coll, ref)


def test_structural_gate(engines):  # noqa: F811
    """A denoiser without a collection samples exactly as before (the bf16 path); the
    collection changes the sample only inside the sampler (a denoise outside it is
    unchanged); stripping restores the exact output; a second calibration gives what the
    first did; a site selection that matches nothing quantizes nothing; IC burn-in with
    a calibrated rew/end model equals the uncalibrated one."""
    e = engines
    p = e["p"]
    obs_u8, act = _conditioning(e, np.arange(B))
    prev = t(np.asarray(j_obs_to_float(jnp.asarray(obs_u8))))
    x0 = t(np.random.default_rng(21).normal(size=(B,) + obs_u8.shape[2:]).astype(np.float32))
    flat_obs = prev.movedim(1, 3).reshape(B, *prev.shape[2:4], -1)
    with torch.no_grad():
        y0 = p.sampler.sample(prev, t(act), x_init=x0)
        d0 = p.denoiser.denoise(x0, 1.3, flat_obs, t(act))
        c1 = p.sampler.calibrate(prev, t(act), x_init=x0)
        yq = p.sampler.sample(prev, t(act), x_init=x0)
        assert torch.equal(p.denoiser.denoise(x0, 1.3, flat_obs, t(act)), d0)
        c2 = p.sampler.calibrate(prev, t(act), x_init=x0)
        for k, v in _leaves(c1).items():
            np.testing.assert_array_equal(_leaves(c2)[k], v, err_msg=k)
        assert not torch.equal(yq, y0), "calibrated int8 sites must change the sample"
        quant.strip(p.denoiser.inner_model)
        assert torch.equal(p.sampler.sample(prev, t(act), x_init=x0), y0)
        assert p.sampler.calibrate(prev, t(act), "lstm", x_init=x0) == {}
        assert not quant.has_collection(p.denoiser.inner_model)
        assert torch.equal(p.sampler.sample(prev, t(act), x_init=x0), y0)

        prep = make_ic_preparer(p.rew_end_model, chunk=8)
        hx0, cx0 = prep(t(e["obs"]), t(e["act"]))
        obs = prev
        p.rew_end_model.calibrate(obs[:, -2:-1], t(act[:, -2:-1]), obs[:, -1:], "all")
        hx1, cx1 = prep(t(e["obs"]), t(e["act"]))
    assert torch.equal(hx0, hx1) and torch.equal(cx0, cx1)


def test_quant_collection_through_the_bridge(engines):  # noqa: F811
    """JAX-calibrated variables -> port (strict load) -> back: the same tree, w_q int8,
    scales f32, values equal; a reload without the collection drops it."""
    e = engines
    _, d_vars, r_vars = e["vars"]
    obs = np.asarray(j_obs_to_float(jnp.asarray(e["obs"][:B])))
    act = e["act"][:B]
    r_cal = _np(e["j"].rew_end_model.calibrate(r_vars, obs[:, -2:-1], act[:, -2:-1],
                                               obs[:, -1:], sites="all"))
    net = e["p"].rew_end_model.net
    load_variables(net, r_cal)
    assert net.lstm.cell.act_scale is not None  # the LSTM's leaf: lstm.cell.act_scale
    back = module_to_variables(net)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(r_cal)
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                              jax.tree_util.tree_leaves_with_path(r_cal)):
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(a, b)
    load_variables(net, r_vars)
    assert not quant.has_collection(net)


def _calibrated(e, sites):
    """JAX variables calibrated as bench.py does (the denoiser on the pool's first B
    buffers, the rew/end model on their last two frames)."""
    _, d_vars, r_vars = e["vars"]
    obs_f = j_obs_to_float(jnp.asarray(e["obs"][:B]))
    act = jnp.asarray(e["act"][:B])
    d_cal = e["j"].sampler.calibrate(d_vars, jax.random.PRNGKey(3), obs_f, act, sites=sites)
    r_cal = e["j"].rew_end_model.calibrate(r_vars, obs_f[:, -2:-1], act[:, -2:-1],
                                           obs_f[:, -1:], sites=sites)
    return d_cal, r_cal


def _jax_rollout(e, d_vars, r_vars, pool_feats, key):
    ac_vars = e["vars"][0]
    pool = jwm.ICPool(obs=jnp.asarray(e["obs"]), act=jnp.asarray(e["act"]), hx=e["hx_j"],
                      cx=e["cx_j"], ptr=jnp.asarray(0, jnp.int32))
    if pool_feats:
        pool = pool.replace(feats=jwm.encode_pool_feats(e["j"].actor_critic, ac_vars, pool.obs))
    st, pool = e["j"].initial_state(pool, B)
    return jax.jit(e["j"].rollout, static_argnums=(6,))(ac_vars, d_vars, r_vars, st, pool,
                                                         key, T)


def _frame_levels(a, b):
    return np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))


@pytest.mark.parametrize("sites", SITES)
@pytest.mark.parametrize("pool_feats", [False, True])
def test_int8_rollout_matches_jax(engines, pool_feats, sites):  # noqa: F811
    e = engines
    _, d_vars, r_vars = e["vars"]
    d_cal, r_cal = _calibrated(e, sites)
    load_variables(e["p"].denoiser.inner_model, _np(d_cal))
    load_variables(e["p"].rew_end_model.net, _np(r_cal))
    p_pool = ICPool(obs=t(e["obs"]), act=t(e["act"]), hx=e["hx_p"], cx=e["cx_p"],
                    ptr=torch.tensor(0))
    if pool_feats:
        p_pool.feats = encode_pool_feats(e["p"].actor_critic, p_pool.obs)
    st_p, p_pool = e["p"].initial_state(p_pool, B)
    key = jax.random.PRNGKey(7)
    traj_p, st_p, p_pool = e["p"].rollout(st_p, p_pool, T, draws=jax_draws(key, T))
    traj_j, st_j, j_pool = _jax_rollout(e, d_cal, r_cal, pool_feats, key)
    _, st_f, _ = _jax_rollout(e, d_vars, r_vars, pool_feats, key)  # the f32 yardstick

    dead = np.asarray(traj_j["dead"])
    assert 0 < dead.sum() < dead.size, "resets and survivors must both occur"
    for k in ("act", "rew", "end", "trunc", "dead"):
        np.testing.assert_array_equal(traj_p[k].numpy(), np.asarray(traj_j[k]), err_msg=k)
    for k in ("logits_act", "val", "val_final", "val_bootstrap"):
        close(traj_p[k], traj_j[k], 1e-3, 1e-3)
    assert int(p_pool.ptr) == int(j_pool.ptr) == B + dead.sum()
    np.testing.assert_array_equal(st_p.ep_len.numpy(), np.asarray(st_j.ep_len))
    np.testing.assert_array_equal(st_p.act_buffer.numpy(), np.asarray(st_j.act_buffer))
    for k in ("re_hx", "re_cx", "ac_hx", "ac_cx"):
        d_port = np.abs(getattr(st_p, k).numpy() - np.asarray(getattr(st_j, k))).max()
        d_int8 = np.abs(np.asarray(getattr(st_j, k)) - np.asarray(getattr(st_f, k))).max()
        assert d_port <= d_int8, (k, d_port, d_int8)
    assert st_p.obs_buffer.dtype == torch.uint8
    d_port = _frame_levels(st_p.obs_buffer.numpy(), st_j.obs_buffer)
    d_int8 = _frame_levels(st_j.obs_buffer, st_f.obs_buffer)
    assert d_port.max() <= d_int8.max() and (d_port > 0).mean() <= (d_int8 > 0).mean(), \
        (d_port.max(), (d_port > 0).mean(), d_int8.max(), (d_int8 > 0).mean())
