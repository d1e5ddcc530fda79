"""__graft_entry__.entry() must trace single-device and
dryrun_multichip(8) must run the sharded pipelines on an 8-device mesh —
here, in-process on the conftest's 8 virtual CPU devices."""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft  # noqa: E402


def test_entry_traces():
    """entry() returns (fn, args) and the fn traces/lowers under jit.
    Full compilation is the driver's job (and slow on XLA:CPU for the
    800×800 flagship); an abstract lowering catches every shape/dtype/
    tracing bug without the compile cost."""
    fn, args = graft.entry()
    jax.jit(fn).lower(*args)  # raises on any tracing error


def test_dryrun_multichip_8_devices():
    """dryrun_multichip(8) on an 8-device CPU mesh — the XLA SoA step and
    the sharded adaptive leg (which exercises trash-tile padding)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual CPU devices")
    graft.dryrun_multichip(8)  # raises on any failure
