"""jit wrappers for public transmission-layer entry points.

The frame/rf.py, frame/satellite.py and sound entry points are long chains
of stream FFTs, complex mixes and elementwise steps.  Called eagerly on an
accelerator, each op would be its own dispatch with its own intermediate
in device memory; under ``jax.jit`` the chain is one compiled program that
XLA fuses.  :func:`plan_jit` makes those entry points self-jitting:

* arg 0 (the host-constant plan dataclass — frozen, ``eq=False`` so it
  hashes by identity) is static, which is required anyway because the
  plans' composed-tap methods are host numpy run at trace time;
* the named ``static`` args are Python scalars that flow into host-side
  tap/phase math (``df``, ``detection``, ...) and must be concrete;
* on the **cpu** backend the wrapper calls the raw function — the test
  suite (CPU, many small plans) keeps its compile-free eager paths;
* inside an outer trace the nested jit is inlined by XLA, so pipelines
  that already jit whole stages pay nothing.
"""

from __future__ import annotations

import functools
import inspect

import jax


def plan_jit(fn, static: tuple = ()):
    """Wrap a public entry point ``fn(plan, *arrays, **scalars)`` so that
    off-CPU calls route through ``jax.jit`` with arg 0 and the named
    ``static`` args static.  See module docstring."""
    names = list(inspect.signature(fn).parameters)
    nums = tuple([0] + sorted(names.index(s) for s in static))
    jfn = jax.jit(fn, static_argnums=nums)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if jax.default_backend() == "cpu":
            return fn(*args, **kwargs)
        return jfn(*args, **kwargs)

    wrapper.__wrapped__ = fn
    return wrapper
