"""Dev-mode sanitizers (SURVEY.md §5.2).

Pure functional JAX has no data races; the analogs of sanitizers here are:

* ``jax_debug_nans`` — enabled globally in tests/conftest.py: any NaN/Inf
  produced by a pipeline fails the test at the producing op.
* :func:`checked` below — checkify-instrumented execution for dev runs:
  wraps a jittable function so float errors (NaN/Inf) raise host-side
  exceptions with source locations instead of propagating silently.
* Sharding-equivalence tests (tests/test_sharding.py) — the detector for
  halo off-by-ones, the actual race-like failure mode of this workload.
"""

from __future__ import annotations

from jax.experimental import checkify


def checked(fn):
    """Wrap a jittable ``fn`` so float errors raise instead of propagating.

    Dev-mode only — the checkify instrumentation costs a few percent and an
    extra output; production pipelines run unwrapped.

        rt_checked = checked(roundtrip)
        out = rt_checked(rgb, 0)   # raises JaxRuntimeError on NaN/Inf
    """
    ck = checkify.checkify(fn, errors=checkify.float_checks)

    def wrapper(*args, **kwargs):
        err, out = ck(*args, **kwargs)
        err.throw()
        return out

    return wrapper
