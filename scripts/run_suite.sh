#!/bin/sh
# Full-suite runner: the whole test suite, split across TWO pytest
# processes with a fresh interpreter each.
#
# Why not one process: jax/XLA:CPU grows fragile once a process holds
# ~165 live compiled executables (the persistent-cache serialize path
# aborts, and later a native compile can segfault), while the same test
# passes in a fresh process. Splitting the run resets the executable count
# per shard; each shard stays well under that ceiling.
#
# The shards are derived from tests/test_*.py (alternating files by name),
# so a new or deleted test file needs no edit here.
#
# Usage, from the repo root:  sh scripts/run_suite.sh [extra pytest args]
# Exit status is non-zero iff any shard fails.
set -u
cd "$(dirname "$0")/.."

SHARD_A=""
SHARD_B=""
i=0
for f in tests/test_*.py; do
    if [ $((i % 2)) -eq 0 ]; then
        SHARD_A="$SHARD_A $f"
    else
        SHARD_B="$SHARD_B $f"
    fi
    i=$((i + 1))
done

# NB: pytest.ini already applies -q; adding another here would double to
# -qq and suppress the "N passed" summary lines entirely.
rc=0
for shard in "$SHARD_A" "$SHARD_B"; do
    # shellcheck disable=SC2086
    JAX_PLATFORMS=cpu python -m pytest $shard "$@" || rc=$?
done
exit $rc
