"""PyTorch port vs the JAX package: the public call forms, on the CPU.

- **Signatures.** Every public function, and every class's ``__init__`` and
  public method, that both packages define at the same module path, and
  every name ``bssm_tpu/__init__.py`` exports: each JAX parameter but
  ``key`` exists in the port under its name, the positional parameters
  before ``key`` bind in the same order, and defaults are equal where both
  have one.  The exceptions are ``DEVIATIONS`` below, each one of
  ``ROADMAP.md``'s deliberate deviations or TPU workarounds; any other
  mismatch fails.
- **Validators.** The JAX package's 26 argument checks and the port's take
  the same valid and invalid inputs and give equal results, or raise the
  same exception with the same message.
- **post_correct by position.** The JAX package's positional order binds
  alike in both, and the port's positional call equals its keyword call
  bit for bit.
- **The EKF update on an injected observation** against the JAX function,
  and the EKF, IEKF and EKPF log-likelihoods against their values before
  ``ekf_update_step`` took ``y_t``.
- **The keyed resamplers**: counts within their bounds, seeded draws that
  replay; and the renamed keywords (``antithetic``, ``want_ccov``,
  ``spec``) in their JAX form.
"""
import torch_threads  # noqa: F401  (one torch thread; first)
import dataclasses
import fnmatch
import importlib
import importlib.util
import inspect
import pkgutil
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bssm_tpu
from bssm_tpu.core import priors as jpriors
from bssm_tpu.core import validate as jval
from bssm_tpu.inference import nlg as jnlg
from bssm_tpu.inference.postcorrect import post_correct as j_post_correct
from bssm_tpu.models import examples as jex

import bssm_tpu_torch as bt
from bssm_tpu_torch.core import priors as tpriors
from bssm_tpu_torch.core import validate as tval
from bssm_tpu_torch.inference import approx as tapprox
from bssm_tpu_torch.inference import approx_mv as tapprox_mv
from bssm_tpu_torch.inference import nlg as tnlg
from bssm_tpu_torch.inference import particle as tpf
from bssm_tpu_torch.models.base import Model
from bssm_tpu_torch.ops import kalman as tkalman
from bssm_tpu_torch.ops import resample as tres

# ---------------------------------------------------------------------------
# signatures
# ---------------------------------------------------------------------------

# The JAX package's public names the port leaves out or gives another
# form, by module path and name, each with its ROADMAP.md entry.
WORKAROUND = "TPU workaround (ROADMAP ground rules, 'Do not port')"
RESULT_NAME = "result class names (ROADMAP deviation, other names)"
NO_SWITCH = "no fused_kernels switch (ROADMAP deviation)"
DEVIATIONS = {
    (".core.config", "set_fused_kernels"): NO_SWITCH,
    (".core.config", "use_fused"): NO_SWITCH,
    (".core.priors", "PriorStack.theta_init"):
        "PriorStack.theta_init raises NotImplementedError in the JAX package",
    (".inference.approx_mv", "MVApproxLoglik"): RESULT_NAME,
    (".inference.approx_mv", "MVApproxResult"): RESULT_NAME,
    (".inference.approx_mv", "MVPFResult"): RESULT_NAME,
    (".inference.nlg", "NLGPFResult"): RESULT_NAME,
    (".inference.mcmc", "is_correction_key"):
        "key -> generator: is_correction_generator",
    (".ops.resample", "stratified_select"): WORKAROUND,
    (".ops.resample", "stratified_gather"): WORKAROUND,
    (".inference.mcmc", "run_mcmc", "output_type"):
        "output_type's default: 'theta', not 'full'",
}
# modules of the JAX package with no port module: the Pallas kernels, whose
# entry points are workarounds of these name patterns (the port's kernels
# are reached through ops/cuda_kalman.py)
MODULE_WORKAROUNDS = {
    ".ops.pallas_kalman": ("fused_*", "*_auto", "*_stream",
                           "get_laplace_solver"),
}
POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
              inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _py_modules(pkg):
    """``{relative path: module name}`` of the Python modules of ``pkg``
    (compiled libraries beside them are not modules)."""
    out = {}
    for mi in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        origin = importlib.util.find_spec(mi.name).origin or ""
        if origin.endswith(".py"):
            out[mi.name[len(pkg.__name__):]] = mi.name
    return out


JAX_MODULES = _py_modules(bssm_tpu)
PORT_MODULES = _py_modules(bt)


def _same_default(a, b) -> bool:
    try:
        return bool(a == b)
    except Exception:
        return a is b


def _allowed(rel, name, param=None) -> bool:
    key = (rel, name) if param is None else (rel, name, param)
    return key in DEVIATIONS


def _float32_default(param, jdefault, tdefault) -> bool:
    """Every port constructor defaults to float32 (ROADMAP deviation;
    ``core/config.DEFAULT_DTYPE``), where the JAX package's take float64."""
    return (param == "dtype" and tdefault is torch.float32
            and "float64" in str(jdefault))


def signature_problems(label, jfn, tfn, rel="", name="") -> list:
    """How the port's ``tfn`` fails to take ``jfn``'s call forms."""
    try:
        js, ts = inspect.signature(jfn), inspect.signature(tfn)
    except (TypeError, ValueError):
        return []
    tp, probs = ts.parameters, []
    for p, jpar in js.parameters.items():
        if p == "key":
            continue
        if p not in tp:
            probs.append(f"{label}: no parameter {p!r}")
            continue
        jd, td = jpar.default, tp[p].default
        if jd is inspect.Parameter.empty or td is inspect.Parameter.empty:
            continue
        if not _same_default(jd, td) and not _allowed(rel, name, p) \
                and not _float32_default(p, jd, td):
            probs.append(f"{label}: default of {p!r} {jd!r} != {td!r}")
    jpos = []
    for p, jpar in js.parameters.items():
        if p == "key":
            break
        if jpar.kind in POSITIONAL:
            jpos.append(p)
    tpos = [p for p, tpar in tp.items() if tpar.kind in POSITIONAL]
    if tpos[:len(jpos)] != jpos:
        probs.append(f"{label}: positional order {jpos} != {tpos}")
    return probs


def _own_members(modname):
    mod = importlib.import_module(modname)
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and getattr(v, "__module__", None) == modname}


def _function(obj):
    if isinstance(obj, (staticmethod, classmethod)):
        obj = obj.__func__
    return obj if inspect.isfunction(obj) else None


def module_problems(rel) -> list:
    if rel not in PORT_MODULES:
        pats = MODULE_WORKAROUNDS.get(rel)
        if pats is None:
            return [f"{rel}: no port module"]
        return [f"{rel}.{k}: not a TPU workaround name"
                for k in _own_members(JAX_MODULES[rel])
                if not any(fnmatch.fnmatch(k, p) for p in pats)]
    tmod = importlib.import_module(PORT_MODULES[rel])
    probs = []
    for name, jobj in sorted(_own_members(JAX_MODULES[rel]).items()):
        tobj = getattr(tmod, name, None)
        if tobj is None:
            if not _allowed(rel, name):
                probs.append(f"{rel}.{name}: missing in the port")
            continue
        if not inspect.isclass(jobj):
            probs += signature_problems(f"{rel}.{name}", jobj, tobj, rel,
                                        name)
            continue
        if not inspect.isclass(tobj):
            probs.append(f"{rel}.{name}: not a class in the port")
            continue
        if "__init__" in vars(jobj):
            probs += signature_problems(f"{rel}.{name}.__init__",
                                        jobj.__init__, tobj.__init__, rel,
                                        name)
        for mname, mobj in vars(jobj).items():
            jm = _function(mobj)
            if mname.startswith("_") or jm is None:
                continue
            qual = f"{name}.{mname}"
            tm = _function(inspect.getattr_static(tobj, mname, None))
            if tm is None:
                if not _allowed(rel, qual):
                    probs.append(f"{rel}.{qual}: missing in the port")
                continue
            probs += signature_problems(f"{rel}.{qual}", jm, tm, rel, qual)
    return probs


@pytest.mark.parametrize("rel", sorted(JAX_MODULES))
def test_module_call_forms_match(rel):
    assert module_problems(rel) == []


def test_exported_call_forms_match():
    """Every name of ``bssm_tpu/__init__.py`` is the port's too, with the
    same call forms; the allow-list names only deviations still found."""
    probs = []
    for name in sorted(vars(bssm_tpu)):
        jobj = getattr(bssm_tpu, name)
        if name.startswith("_") or (inspect.ismodule(jobj)
                                    and name != "example_models"):
            continue
        tobj = getattr(bt, name, None)
        if tobj is None:
            probs.append(f"{name}: not exported by the port")
        elif inspect.isfunction(jobj):
            rel = jobj.__module__[len("bssm_tpu"):]
            probs += signature_problems(name, jobj, tobj, rel, name)
        elif inspect.isclass(jobj) and "__init__" in vars(jobj):
            probs += signature_problems(name, jobj.__init__, tobj.__init__)
    assert probs == []
    # an entry of the allow-list that no longer deviates is stale
    for key in DEVIATIONS:
        rel, name = key[:2]
        tmod = importlib.import_module(PORT_MODULES[rel])
        owner, _, attr = name.partition(".")
        obj = getattr(tmod, owner, None)
        if attr:
            obj = None if obj is None else getattr(obj, attr, None)
        if len(key) == 2:
            assert obj is None, key
        else:
            jobj = getattr(importlib.import_module(JAX_MODULES[rel]), name)
            p = key[2]
            assert not _same_default(
                inspect.signature(jobj).parameters[p].default,
                inspect.signature(obj).parameters[p].default), key


# ---------------------------------------------------------------------------
# the 26 validators
# ---------------------------------------------------------------------------

N_OBS, M = 10, 2


def _validator_calls(P):
    """``{validator: [args, ...]}``, valid and invalid inputs; ``P`` the
    package's priors module (each package checks its own priors)."""
    n, m = N_OBS, M
    y = np.arange(1.0, n + 1)
    y_nan = y.copy()
    y_nan[3] = np.nan
    y2 = np.column_stack([y, y + 0.5])
    prior = P.halfnormal_prior(0.1, 1.0)
    priors2 = P.normal_prior(np.zeros(2), 0.0, 1.0)
    return {
        "check_y": [(y,), (y_nan,), (y, False, "poisson"),
                    (y + 0.5, False, "poisson"), (-y, False, "gamma"),
                    (y2, True), (y, True), (y2,), (y[:1],),
                    (np.r_[y, np.inf],)],
        "check_u": [(2.0, y), (np.ones(n), y), (np.zeros(n), y),
                    (np.r_[np.ones(n - 1), np.nan], y)],
        "check_sd": [(0.5, "level"), (0.0, "slope"), (-1.0, "level"),
                     (np.ones(2), "y")],
        "check_phi": [(2.0,), (0.0,), (-1.0,)],
        "check_rho": [(0.5,), (-0.99,), (1.0,), (-1.0,)],
        "check_prop": [(0.234,), (0.0,), (1.0, "p")],
        "check_positive_int": [(3, "n"), (0, "n"), (2.5, "n"), (-1, "n")],
        "check_matrix": [(np.eye(2), "A", (2, 2)), (np.eye(2), "A", (3, 3)),
                         (np.array([[np.nan, 0], [0, 1.0]]), "A", (2, 2))],
        "check_period": [(4, n), (None, n), (2, n), (n, n)],
        "check_distribution": [
            (np.column_stack([y, -y]), ("poisson", "gaussian")),
            (np.column_stack([y, -y]), ("poisson", "gamma")),
            (np.column_stack([y + 0.5, y]), ("poisson", "gaussian")),
            (np.column_stack([y + 0.5, y]), ("gamma", "binomial"))],
        "check_xreg": [(np.ones((n, 2)), n), (np.arange(n), n),
                       (np.ones((n - 1, 2)), n),
                       (np.r_[np.ones(n - 1), np.nan], n)],
        "check_beta": [(priors2, 2), (prior, 1), (np.zeros(2), 2),
                       (np.zeros(3), 2), (np.r_[np.nan, 0.0], 2)],
        "check_mu": [(prior,), (0.5,), (np.ones(2),), (np.nan,)],
        "check_prior": [(prior, "sd_y"), (priors2, "beta"), (0.5, "sd_y"),
                        ([], "beta"), ([prior, 0.5], "beta")],
        "check_D": [(None, 1, n), (2.0, 1, n), (np.ones(n), 1, n),
                    (np.ones(4), 1, n), (None, 2, n), (np.ones(2), 2, n),
                    (np.ones((2, n)), 2, n), (np.ones((3, 1)), 2, n)],
        "check_C": [(None, m, n), (np.ones(m), m, n), (np.ones((m, n)), m, n),
                    (np.ones((m, 5)), m, n)],
        "check_Z": [(np.ones(m), 1, n), (1.0, 1, n), (np.ones((m, n)), 1, n),
                    (np.ones((m, 3)), 1, n), (np.ones((2, m)), 2, n, True),
                    (np.ones((2, m, n)), 2, n, True),
                    (np.ones((3, m)), 2, n, True)],
        "check_T": [(1.0, 1, n), (np.eye(m), m, n),
                    (np.ones((m, m, n)), m, n), (np.ones((m, 3)), m, n),
                    (np.ones((m, m, 4)), m, n)],
        "check_R": [(np.ones(m), m, n), (np.ones((m, 1)), m, n),
                    (np.ones((m, 1, n)), m, n), (np.ones((m, m + 1)), m, n)],
        "check_a1": [(None, m), (1.0, m), (np.arange(m), m),
                     (np.ones(3), m)],
        "check_P1": [(None, m), (2.0, 1), (np.eye(m), m),
                     (np.ones((m, 3)), m)],
        "check_H": [(2.0, 1, n), (np.ones(n), 1, n), (np.ones(3), 1, n),
                    (0.5, 2, n, True), (np.eye(2), 2, n, True),
                    (np.ones((2, 2, n)), 2, n, True),
                    (np.ones((3, 3)), 2, n, True)],
        "check_intmax": [(10,), (0,), (0, "burnin", False),
                         (-1, "burnin", False), (2.5,), (200000,),
                         (5, "N", True, 4)],
        "check_positive_real": [(1.5, "x"), (0, "x"), (-1.0, "x"),
                                (np.inf, "x")],
        "check_theta": [([1.0, 2.0],), (3.0,), (np.eye(2),)],
        "check_missingness": [({"y": y_nan, "T": np.ones(2)},),
                              ({"Z": None, "T": np.r_[1.0, np.nan]},),
                              ({"H": np.ones(n)},)],
    }


JAX_CALLS = _validator_calls(jpriors)
PORT_CALLS = _validator_calls(tpriors)


def _call(fn, args):
    try:
        return fn(*args), None
    except Exception as e:                     # noqa: BLE001
        return None, e


@pytest.mark.parametrize("name", sorted(JAX_CALLS))
def test_validator_matches_jax(name):
    assert len(JAX_CALLS) == 26
    jfn, tfn = getattr(jval, name), getattr(tval, name)
    for jargs, targs in zip(JAX_CALLS[name], PORT_CALLS[name]):
        want, jerr = _call(jfn, jargs)
        if jerr is not None:
            with pytest.raises(type(jerr), match=re.escape(str(jerr))):
                tfn(*targs)
            continue
        got, terr = _call(tfn, targs)
        assert terr is None, (name, jargs, terr)
        if want is jargs[0]:                   # a prior or a list, as given
            assert got is targs[0], (name, jargs)
        elif isinstance(want, np.ndarray):
            assert isinstance(got, np.ndarray) and got.dtype == want.dtype
            assert np.array_equal(got, want, equal_nan=True), (name, jargs)
        else:
            assert type(got) is type(want) and got == want, (name, jargs)
    # every validator meets at least one input it refuses
    assert any(_call(jfn, a)[1] is not None for a in JAX_CALLS[name])


# ---------------------------------------------------------------------------
# post_correct by position
# ---------------------------------------------------------------------------

def _small_ng(n=20, seed=13):
    rng = np.random.default_rng(seed)
    y = rng.poisson(np.exp(np.cumsum(rng.normal(0, .1, n)) + 1.0))
    return bt.bsm_ng(y.astype(float), sd_level=bt.halfnormal_prior(0.1, 1),
                     sd_slope=bt.halfnormal_prior(0.01, 0.1),
                     distribution="poisson", a1=np.r_[1.0, 0.0],
                     P1=0.5 * np.eye(2), dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def approx_run():
    tm = _small_ng()
    ap = bt.run_mcmc(tm, mcmc_type="approx", iter=40, particles=8, seed=7,
                     n_chains=2, output_type="full", device="cpu")
    return tm, ap


def _array_fields(out) -> dict:
    return {f.name: getattr(out, f.name) for f in dataclasses.fields(out)
            if isinstance(getattr(out, f.name), np.ndarray)}


@pytest.mark.parametrize("output_type", ["theta", "full"])
def test_post_correct_binds_the_jax_order(approx_run, output_type):
    """The JAX package's positional order, up to ``output_type``, binds
    the same parameters in both; the generator sits in ``key``'s place;
    the positional call equals the keyword call bit for bit."""
    tm, ap = approx_run
    args = (tm, ap, 8, "psi", 2, 1, None, 16, output_type)
    jb = inspect.signature(j_post_correct).bind(*args).arguments
    tb = inspect.signature(bt.post_correct).bind(*args).arguments
    assert list(jb) == list(tb)
    assert all(jb[k] is tb[k] for k in jb)
    assert tb["mesh"] is None and tb["corr_batch"] == 16
    assert tb["output_type"] == output_type
    gen = bt.is_correction_generator(7, "cpu")
    assert inspect.signature(j_post_correct).bind(
        *args, gen).arguments["key"] is gen
    assert inspect.signature(bt.post_correct).bind(
        *args, gen).arguments["generator"] is gen
    pos = bt.post_correct(*args, bt.is_correction_generator(7, "cpu"))
    kw = bt.post_correct(tm, ap, 8, output_type=output_type, corr_batch=16,
                         generator=bt.is_correction_generator(7, "cpu"))
    assert pos.output_type == kw.output_type == output_type
    got, want = _array_fields(pos), _array_fields(kw)
    assert list(got) == list(want) and "weights" in got
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert (pos.alpha is None) == (output_type == "theta")


# ---------------------------------------------------------------------------
# the EKF update on an injected observation
# ---------------------------------------------------------------------------

def _sin_exp_series(n=40, seed=0):
    rng = np.random.default_rng(seed)
    a = np.zeros(n)
    for t in range(1, n):
        a[t] = np.sin(a[t - 1]) + 0.5 * rng.normal()
    y = np.exp(a) + 0.6 * rng.normal(size=n)
    y[n // 3] = np.nan
    return y


SIN_EXP_ROWS = np.array([[0, 0], [0.3, -0.2], [-0.4, 0.3]])


@pytest.mark.parametrize("iekf_iter", [0, 2])
def test_ekf_update_step_takes_y_t(iekf_iter):
    """``ekf_update_step(spec, t, y_t, a, P)`` with an observation other
    than ``spec.y[t]``, random states and covariances, against the JAX
    function row by row (float64, 1e-10); at the missing time point the
    update leaves a and P as they are in both."""
    y = _sin_exp_series()
    jm = jex.nlg_sin_exp(y)
    tm = bt.example_models.nlg_sin_exp(y, dtype=torch.float64, device="cpu")
    th = np.asarray(jm.theta_init) + SIN_EXP_ROWS
    spec = dataclasses.replace(tm.build(torch.as_tensor(th)),
                               iekf_iter=iekf_iter)
    rng = np.random.default_rng(4)
    B = th.shape[0]
    a = rng.normal(0.0, 0.5, (B, 1))
    L = rng.normal(0.0, 0.4, (B, 1, 1))
    P = L @ np.swapaxes(L, -1, -2) + 0.1
    for t in (5, len(y) // 3):
        y_t = y[t:t + 1] + 0.7
        got = tnlg.ekf_update_step(spec, t, torch.as_tensor(y_t),
                                   torch.as_tensor(a), torch.as_tensor(P))
        want = jax.jit(jax.vmap(lambda tt, aa, PP: jnlg.ekf_update_step(
            jm.build(tt).replace(iekf_iter=iekf_iter), t, jnp.asarray(y_t),
            aa, PP)))(jnp.asarray(th), jnp.asarray(a), jnp.asarray(P))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                       atol=1e-10)
        if t == len(y) // 3:
            np.testing.assert_array_equal(got[0].numpy(), a)
    shifted = tnlg.ekf_update_step(spec, 5, spec.y[5] + 0.7,
                                   torch.as_tensor(a), torch.as_tensor(P))
    plain = tnlg.ekf_update_step(spec, 5, spec.y[5], torch.as_tensor(a),
                                 torch.as_tensor(P))
    assert not torch.equal(shifted[0], plain[0])


# float64 log-likelihoods of the three rows before ``ekf_update_step`` took
# ``y_t`` (float.hex): EKF and EKPF (16 particles, generator seed 5)
EKF_BEFORE = {
    0: ("-0x1.94b3812e71805p+5", "-0x1.ae6597b98b4fep+5",
        "-0x1.94880539d0879p+5"),
    2: ("-0x1.9a09c2a3a6e1bp+5", "-0x1.b04c5d53c5d86p+5",
        "-0x1.9ffccd0dd66acp+5")}
EKPF_BEFORE = {
    0: ("-0x1.a105931c5fc1ap+5", "-0x1.a89b2dced43bdp+5",
        "-0x1.a407b0f7a3e22p+5"),
    2: ("-0x1.9d486a6640f45p+5", "-0x1.a89cb762cd2f7p+5",
        "-0x1.9e3ad471e3086p+5")}


@pytest.mark.parametrize("iekf_iter", [0, 2])
def test_ekf_and_ekpf_unchanged(iekf_iter):
    """The filters pass ``spec.y[t]`` as ``y_t``: EKF, IEKF and EKPF give
    what they gave before, to roundoff."""
    tm = bt.example_models.nlg_sin_exp(_sin_exp_series(),
                                       dtype=torch.float64, device="cpu")
    spec = dataclasses.replace(
        tm.build(torch.as_tensor(np.asarray(tm.theta_init) + SIN_EXP_ROWS)),
        iekf_iter=iekf_iter)
    ekf = tnlg.ekf(spec).logLik.numpy()
    ekpf = tnlg.ekpf_filter(spec, 16, torch.Generator().manual_seed(5),
                            keep_paths=False).numpy()
    for got, want in ((ekf, EKF_BEFORE[iekf_iter]),
                      (ekpf, EKPF_BEFORE[iekf_iter])):
        np.testing.assert_allclose(got, [float.fromhex(h) for h in want],
                                   rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# the keyed resamplers and the JAX keyword names
# ---------------------------------------------------------------------------

def _weights(shape, seed=0):
    w = np.random.default_rng(seed).gamma(0.3, size=shape)
    return torch.as_tensor(w / w.sum(-1, keepdims=True))


@pytest.mark.parametrize("kind,bound", [("systematic", 1.0),
                                        ("stratified", 2.0)])
def test_keyed_resamplers(kind, bound):
    """Indices in range; each particle's count within ``bound`` of N w_k
    (1 for systematic, 2 for stratified, for any draw); leading batch axes;
    one seed replays, another draws anew."""
    fn = getattr(tres, f"{kind}_indices")
    w = _weights((4, 256, 64))
    idx = fn(w, torch.Generator().manual_seed(3))
    assert idx.shape == w.shape and idx.dtype == torch.int64
    assert int(idx.min()) >= 0 and int(idx.max()) < 64
    flat = idx.reshape(-1, 64)
    counts = torch.zeros_like(flat).scatter_add_(1, flat,
                                                 torch.ones_like(flat))
    dev = (counts.double() - 64 * w.reshape(-1, 64)).abs()
    assert float(dev.max()) <= bound + 1e-9, float(dev.max())
    assert torch.equal(idx, fn(w, torch.Generator().manual_seed(3)))
    assert not torch.equal(idx, fn(w, torch.Generator().manual_seed(4)))
    if kind == "systematic":        # one uniform a row: strata evenly apart
        r = torch.rand(w.shape[:-1] + (1,), dtype=w.dtype,
                       generator=torch.Generator().manual_seed(3))
        assert torch.equal(idx, tres.stratified_indices_from_uniforms(
            w, r.expand(w.shape)))


def test_jax_keyword_forms():
    """``spdk_sample`` / ``spdk_sample_mv`` take ``antithetic``,
    ``smoother`` ``want_ccov``, ``gaussian_approx`` ``spec=``, ``Model``
    the JAX package's positional order and the specs ``replace``."""
    tm = _small_ng()
    spec = tm.build(torch.as_tensor(np.tile(tm.theta_init, (3, 1))))
    al = tapprox.approx_loglik(spec)
    base = tpf.spdk_sample(spec, al, 6, torch.Generator().manual_seed(1))
    same = tpf.spdk_sample(spec, al, 6, torch.Generator().manual_seed(1),
                           antithetic=True)
    for g, w in zip(same, base):
        assert torch.equal(g, w)
    plain = tpf.spdk_sample(spec, al, 6, torch.Generator().manual_seed(1),
                            antithetic=False)
    assert plain.alpha.shape == base.alpha.shape
    assert not torch.equal(plain.alpha, base.alpha)
    # antithetic pairs sum to 2 alphahat; independent draws do not
    for r, pairs in ((base, True), (plain, False)):
        s = r.alpha[:, :3] + r.alpha[:, 3:]
        assert torch.allclose(s, s[:, :1].expand_as(s), atol=1e-9) == pairs
    mng = bt.ssm_mng(np.column_stack([np.arange(12.0) % 4,
                                      np.linspace(0, 1, 12)]),
                     Z=np.eye(2), T=0.9 * np.eye(2), R=0.2 * np.eye(2),
                     distributions=["poisson", "gaussian"],
                     phi=np.array([1.0, 0.5]), P1=np.eye(2),
                     init_theta=(0.0,), update_fn=lambda th: {},
                     prior_fn=lambda th: -0.5 * (th ** 2).sum(-1),
                     dtype=torch.float64, device="cpu")
    mspec = mng.build(torch.zeros(2, 1, dtype=torch.float64))
    mal = tapprox_mv.approx_loglik_mv(mspec)
    r1 = tapprox_mv.spdk_sample_mv(mspec, mal, 4,
                                   torch.Generator().manual_seed(2))
    r2 = tapprox_mv.spdk_sample_mv(mspec, mal, 4,
                                   torch.Generator().manual_seed(2),
                                   antithetic=True)
    r3 = tapprox_mv.spdk_sample_mv(mspec, mal, 4,
                                   torch.Generator().manual_seed(2),
                                   antithetic=False)
    assert all(torch.equal(g, w) for g, w in zip(r1, r2))
    assert torch.isfinite(r3.loglik).all()
    g = tapprox.gaussian_approx(tm)
    for s in (tapprox.gaussian_approx(spec=tm),
              bt.gaussian_approx(spec=tm, conv_tol=1e-8, max_iter=100)):
        for f in g._fields:
            assert torch.equal(getattr(s, f), getattr(g, f)), f
    lg = g._replace(y=g.y.expand(2, -1))
    for a, b in zip(tkalman.smoother(lg, want_ccov=True),
                    tkalman.smoother(lg)):
        assert torch.equal(a, b)
    m2 = Model(tm.build, tm.log_prior, tm.theta_init, tm.theta_names,
               tm.transforms, tm.kind, {"note": 1}, device=tm.device,
               dtype=tm.dtype)
    assert m2.extra == {"note": 1} and m2.dtype == torch.float64
    assert torch.equal(spec.replace(phi=spec.phi + 1).phi, spec.phi + 1)
