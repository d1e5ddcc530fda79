"""Debugging aids — the JAX-side analog of the reference's ERRORCHECK
(`pathtrace.cu:137-150`, a device sync + error check after every kernel).

JAX's functional model removes the data-race and async-error classes the
reference guarded against; what remains worth catching is numeric poison
(NaN/Inf radiance) and shape/type drift, handled by jax's debug flags and
checkify."""

from __future__ import annotations

import jax
import jax.numpy as jnp


def enable_nan_checks() -> None:
    """Fail loudly (with a traceback into the jitted code) when any
    computation produces a NaN — debug builds only; disables some fusion."""
    jax.config.update("jax_debug_nans", True)


def disable_nan_checks() -> None:
    jax.config.update("jax_debug_nans", False)


def validate_radiance(accum, iteration: int) -> dict:
    """On-device health check of the accumulator: NaN/Inf counts and basic
    stats. Cheap enough to run at checkpoint cadence."""
    accum = jnp.asarray(accum)
    nan_count = int(jnp.isnan(accum).sum())
    inf_count = int(jnp.isinf(accum).sum())
    mean = float(jnp.nan_to_num(accum).mean() / max(iteration, 1))
    peak = float(jnp.nan_to_num(accum).max() / max(iteration, 1))
    return {
        "nan_count": nan_count,
        "inf_count": inf_count,
        "mean_radiance": mean,
        "peak_radiance": peak,
        "healthy": nan_count == 0 and inf_count == 0,
    }
