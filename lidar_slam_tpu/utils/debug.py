"""Debug-assert mode: the JAX analog of the sanitizer layer the
reference never had.

SURVEY §5 lists the reference's latent memory hazards a sanitizer would have
flagged: map append without capacity check (main.c:944-953), grid scatter
without bounds check (main.c:352-353), uninitialized reads
(esp32_edge.c:906-907). The JAX pipeline removes that hazard class by
construction (fixed shapes, masked writes, ``mode="drop"`` scatters), but
numeric hazards remain — NaN/Inf poses from a degenerate solve, weight
collapse, saturated fixed-capacity stores silently truncating. This module
makes those checkable:

- :func:`validate_state` — host-side invariant audit of any model state
  (finiteness everywhere, capacity counters within bounds, particle weights
  normalizable). Cheap enough to run per-chunk in host loops.
- :func:`checked` — wraps a jittable step with ``jax.experimental.checkify``
  so NaN production and division-by-zero are caught INSIDE the compiled
  program and reported with location, on GPU as on CPU (the ASan/UBSan
  analog; out-of-bounds checks are opt-in because the pipeline uses
  intentional clamp/drop indexing).
- ``run --debug-checks`` (CLI) audits the final state and trajectory of any
  mode with :func:`validate_state`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _is_float(a) -> bool:
    return np.issubdtype(np.asarray(a).dtype, np.floating)


def validate_state(state, name: str = "state") -> list:
    """Audit a model-state pytree; returns a list of violation strings.

    Generic: every floating leaf must be finite. Duck-typed extras:
    - ``pmap`` (PointMap): ``0 <= size <= capacity``;
    - ``logw`` (particle log-weights): not all -inf (weight collapse);
    - ``mini_updated``/``step`` counters: finite and sane.
    """
    bad: list = []
    leaves = jax.tree_util.tree_leaves_with_path(state)
    for path, leaf in leaves:
        arr = np.asarray(leaf)
        if _is_float(arr) and not np.isfinite(arr).all():
            n = int((~np.isfinite(arr)).sum())
            bad.append(f"{name}{jax.tree_util.keystr(path)}: {n} non-finite "
                       f"of {arr.size}")
    pmap = getattr(state, "pmap", None)
    if pmap is not None and hasattr(pmap, "size") and hasattr(pmap, "xy"):
        size = int(np.asarray(pmap.size))
        cap = int(np.asarray(pmap.xy).shape[-2])
        if not 0 <= size <= cap:
            bad.append(f"{name}.pmap.size={size} outside [0, {cap}]")
    logw = getattr(state, "logw", None)
    if logw is not None:
        lw = np.asarray(logw)
        if lw.size and not np.isfinite(lw).any():
            bad.append(f"{name}.logw: all weights collapsed (-inf/NaN)")
    step = getattr(state, "step", None)
    if step is not None:
        s = int(np.asarray(step))
        if s < 0:
            bad.append(f"{name}.step={s} negative")
    return bad


def assert_valid(state, name: str = "state") -> None:
    """Raise ``AssertionError`` listing every violated invariant."""
    bad = validate_state(state, name)
    if bad:
        raise AssertionError("state invariants violated:\n  "
                             + "\n  ".join(bad))


def checked(fn, *, nan_checks: bool = True, div_checks: bool = True,
            index_checks: bool = False, jit: bool = True):
    """Instrument a jittable function with in-program error checks.

    Returns a wrapper that raises ``checkify.JaxRuntimeError`` (with the
    failing primitive's location) when the compiled program produces a NaN
    or divides by zero — on any backend, inside jit. ``index_checks`` is
    off by default: the pipeline indexes with intentional clamp/drop
    semantics (e.g. the raster scatter routes invalid points to a drop
    slot), which strict bounds checking would misflag."""
    from jax.experimental import checkify

    errors = checkify.user_checks
    if nan_checks:
        errors = errors | checkify.nan_checks
    if div_checks:
        errors = errors | checkify.div_checks
    if index_checks:
        errors = errors | checkify.index_checks
    cfn = checkify.checkify(fn, errors=errors)
    if jit:
        cfn = jax.jit(cfn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        checkify.check_error(err)
        return out

    return wrapper


def check(pred, msg: str, **fmt) -> None:
    """In-program assertion usable inside jitted code wrapped by
    :func:`checked` (forwarding of ``checkify.check``)."""
    from jax.experimental import checkify

    checkify.check(pred, msg, **fmt)


def finite_or_revert(new, old):
    """Pytree guard: return ``new`` where every float leaf is finite, else
    ``old`` (whole-tree revert). The jit-friendly recovery idiom used by the
    loop-closure optimizer, exposed for reuse."""
    leaves = [jnp.all(jnp.isfinite(x)) for x in jax.tree_util.tree_leaves(new)
              if np.issubdtype(jnp.asarray(x).dtype, np.floating)]
    ok = functools.reduce(jnp.logical_and, leaves, jnp.bool_(True))
    return jax.tree_util.tree_map(
        lambda a, b: jnp.where(ok, a, b) if a.shape == b.shape else a,
        new, old)
