"""Exit-code restart policy table: own copy of tf_operator_tpu/utils/exit_codes.py.

Capability parity with pkg/util/train/train_util.go:18-55: under
RestartPolicy.EXIT_CODE the operator restarts a replica only when its exit
code signals a transient condition.

  - 1..127 are "permanent" errors (app bug, bad image, OOM-kill by runtime):
    never retried — except 130/126+ signal range below.
  - 128+n means killed by signal n. SIGTERM(143)=128+15, SIGKILL(137)=128+9,
    SIGINT(130)=128+2 are infrastructure preemption/eviction: retryable.
    SIGSEGV(139)=128+11 is an app crash: permanent.
  - 138 = 128+SIGUSR1 is reserved as a *user-declared retryable* failure, so a
    workload can request its own restart.
"""

from __future__ import annotations

RETRYABLE_EXIT_CODES = frozenset({130, 137, 138, 143})
PERMANENT_EXIT_CODES = frozenset({1, 2, 126, 127, 128, 139})

# 128+SIGUSR1: the workload ASKING for its own restart — numerically in the
# signal range but semantically an app-declared retryable, not an
# infrastructure kill (restart metrics label it exit_code, not preempt).
EXIT_USER_RETRYABLE = 138


def is_retryable_exit_code(exit_code: int) -> bool:
    if exit_code in RETRYABLE_EXIT_CODES:
        return True
    if exit_code in PERMANENT_EXIT_CODES:
        return False
    # Unknown 1..127: app-level error, permanent. Unknown 128+: signal, retry.
    return exit_code > 128


def is_signal_exit(exit_code: int) -> bool:
    return exit_code > 128


def signal_of(exit_code: int) -> int | None:
    return exit_code - 128 if exit_code > 128 else None
