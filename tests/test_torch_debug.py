"""The port's numerical-debug hooks (``tpudl_torch.debug``) against
tpudl's (``tpudl.debug``: ``jax_debug_nans`` and ``checkify``).

The same numpy inputs through tpudl's jitted functions and the port's
torch functions: a NaN from ``log`` of a negative, an integer division
by zero and an out-of-range index raise in both (the port's typed errors
carry jax's names and messages), and clean inputs give equal outputs
(f32, within 1e-6 relative: one op on one value). Errors are recorded
without a sync and an out-of-range index is clamped before it is used;
``debug_nans`` names the operation and the module, catches a NaN in the
backward through anomaly mode, and restores everything on exit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import checkify as jcheckify

from tpudl import debug as tdebug
from tpudl_torch import debug
from tpudl_torch import compilation_cache

RTOL = 1e-6

X = np.array([0.5, 1.0, 2.0, 4.0], np.float32)

# (name, jax fn, torch fn, clean args, bad args, port error, message)
CASES = [
    ("nan", lambda x: jnp.log(x) * 2.0, lambda x: torch.log(x) * 2.0,
     (X,), (np.array([-1.0, 2.0], np.float32),), debug.NaNError,
     "nan generated by primitive: log"),
    ("div", lambda a, b: lax.div(a, b),
     lambda a, b: torch.div(a, b, rounding_mode="trunc"),
     (np.array([7, -8], np.int32), np.array([2, 3], np.int32)),
     (np.array([7, 8], np.int32), np.array([0, 3], np.int32)),
     debug.DivisionByZeroError, "division by zero"),
    ("oob", lambda x, i: x[i], lambda x, i: x[i],
     (np.arange(4.0, dtype=np.float32), np.array(2, np.int32)),
     (np.arange(4.0, dtype=np.float32), np.array(17, np.int32)),
     debug.OOBError,
     "index 17 is out of bounds for axis 0 with size 4"),
    ("embedding", lambda t, w: w[t].sum(-1),
     lambda t, w: torch.nn.functional.embedding(t, w).sum(-1),
     (np.array([[1, 3]], np.int32),
      np.linspace(0, 1, 40, dtype=np.float32).reshape(10, 4)),
     (np.array([[1, 12]], np.int32),
      np.linspace(0, 1, 40, dtype=np.float32).reshape(10, 4)),
     debug.OOBError,
     "index 12 is out of bounds for axis 0 with size 10"),
]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_checkify_fn_raises_where_tpudls_does(case):
    name, jfn, tfn, clean, bad, error, message = case
    theirs = tdebug.checkify_fn(jfn)
    ours = debug.checkify_fn(tfn)
    # as device arrays: a numpy index is static to jax, checked at trace
    want = np.asarray(theirs(*map(jnp.asarray, clean)))
    got = ours(*map(_t, clean)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    with pytest.raises(jcheckify.JaxRuntimeError) as jerr:
        theirs(*map(jnp.asarray, bad))
    with pytest.raises(error, match=message) as terr:
        ours(*map(_t, bad))
    assert isinstance(terr.value, debug.CheckifyError)
    assert message.split(":")[0] in str(jerr.value)


@pytest.mark.parametrize("op", ["floordiv", "remainder", "fmod"])
def test_every_integer_division_is_checked(op):
    """tpudl's ``a // b`` masks a zero divisor (jnp.floor_divide), so its
    checkify flags only ``lax.div``; the port flags each integer division
    and remainder, and keeps the op defined (a zero divisor reads 1)."""
    fn = {"floordiv": lambda a, b: a // b,
          "remainder": lambda a, b: torch.remainder(a, b),
          "fmod": lambda a, b: torch.fmod(a, b)}[op]
    a, b = torch.tensor([7, 8]), torch.tensor([0, 3])
    f = debug.checkify_fn(fn)
    with pytest.raises(debug.DivisionByZeroError):
        f(a, b)
    with debug._CheckMode(f):       # the body alone: what the op computed
        out = f.fn(a, b)
    assert out.tolist() == fn(a, torch.tensor([1, 3])).tolist()
    # floating division by zero is IEEE's inf, unchecked as in tpudl
    debug.checkify_fn(lambda x, y: x / y)(torch.ones(1), torch.zeros(1))


def test_a_check_switched_off_stays_quiet():
    debug.checkify_fn(lambda x: torch.log(x), nan=False)(
        torch.tensor([-1.0]))
    w = torch.ones(3, 2)
    assert debug.checkify_fn(lambda t: w[t], oob=False)(
        torch.tensor([1])).shape == (1, 2)


def test_the_first_error_wins_and_the_index_is_clamped():
    w = torch.arange(12.0).reshape(6, 2)
    f = debug.checkify_fn(lambda t, d: (w[t] / d, torch.log(-w[t])))
    with pytest.raises(debug.OOBError, match="index 9"):
        f(torch.tensor([1, 9]), torch.tensor([0.0, 1.0]))
    # what ran used the clamped index: rows 1 and 5
    assert f.error.item() != 0
    out = debug.checkify_fn(lambda t: w[t])
    with pytest.raises(debug.OOBError):
        out(torch.tensor([-7, 2]))
    assert out(torch.tensor([-6, 5])).tolist() == [[0.0, 1.0],
                                                   [10.0, 11.0]]


def test_errors_wait_for_check_when_nothing_may_sync():
    f = debug.checkify_fn(lambda x: torch.sqrt(x))
    f._buffers((torch.zeros(1),))
    f.error.zero_()
    with debug._CheckMode(f):        # the captured body: no read back
        f.fn(torch.tensor([-4.0]))
    assert f.error.item() != 0
    with pytest.raises(debug.NaNError, match="sqrt"):
        f.check()
    f(torch.tensor([4.0]))           # a clean call clears it
    f.check()


def test_debug_nans_raises_where_tpudls_does_and_restores():
    jf = jax.jit(lambda x: jnp.log(x))
    with tdebug.debug_nans():
        with pytest.raises(FloatingPointError, match="nan"):
            jf(jnp.array([-1.0]))
    with debug.debug_nans():
        with pytest.raises(FloatingPointError,
                           match=r"invalid value \(nan\) encountered in log"):
            torch.log(torch.tensor([-1.0]))
        assert torch.is_anomaly_enabled()
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()
    with debug.debug_nans(enable=False):
        torch.log(torch.tensor([-1.0]))


def test_debug_nans_names_the_module_and_checks_the_backward():
    lin = torch.nn.Linear(2, 2)
    with torch.no_grad():
        lin.weight.fill_(float("inf"))
        lin.bias.fill_(-float("inf"))
    x = torch.ones(1, 2)
    with debug.debug_nans():
        with pytest.raises(FloatingPointError, match="inside module Linear"):
            torch.nn.Sequential(lin)(x)
    w = torch.tensor([0.0], requires_grad=True)
    y = torch.sqrt(w)                   # forward fine: 0
    with debug.debug_nans():
        with pytest.raises(RuntimeError, match="nan"):
            (y * 0.0).sum().backward()  # d sqrt at 0 is inf; * 0 -> nan


def test_clean_runs_are_unchanged_under_debug_nans():
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(8, 8), torch.nn.GELU(),
                              torch.nn.Linear(8, 1))
    x = torch.randn(4, 8)
    plain = net(x).sum()
    plain.backward()
    g0 = [p.grad.clone() for p in net.parameters()]
    net.zero_grad()
    with debug.debug_nans():
        armed = net(x).sum()
        armed.backward()
    assert torch.equal(armed, plain)
    assert all(torch.equal(p.grad, g) for p, g in zip(net.parameters(), g0))


def test_the_compilation_cache_shim_keeps_the_old_spelling():
    from tpudl_torch.compile import enable_compilation_cache

    assert compilation_cache.enable_compilation_cache is \
        enable_compilation_cache
