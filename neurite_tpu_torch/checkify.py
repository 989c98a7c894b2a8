"""
In-graph checks: the port's counterpart of the parts of
`jax.experimental.checkify` that the JAX package uses (`check`, the error
value a checked step returns, and its `get` and `throw`).

Inside `collect()` a check reads nothing back to the host: it records its
condition as a 0-d boolean tensor on the condition's device, and `error()`
folds the recorded conditions into one device tensor, the index of the
first that failed. `Error.get()` and `Error.throw()` are then the one host
read. Outside `collect()`, `check` raises at once, as an eager
`checkify.check` does.
"""

import contextlib
import contextvars

import torch

__all__ = ['CheckError', 'Error', 'check', 'collect', 'error']

# the checks recorded by the innermost `collect()` (None outside one)
_recorded = contextvars.ContextVar('neurite_tpu_torch_checks', default=None)


class CheckError(RuntimeError):
    """A failed check (checkify's JaxRuntimeError)."""


def _message(msg):
    return f'{msg} (`check` failed)'


def check(ok, msg):
    """Assert the 0-d boolean tensor `ok`, with message `msg`: recorded
    inside `collect()`, raised as CheckError at once outside it."""
    recorded = _recorded.get()
    if recorded is None:
        if not bool(ok):
            raise CheckError(_message(msg))
        return
    recorded.append((ok.detach().reshape(()), _message(msg)))


@contextlib.contextmanager
def collect():
    """Record the checks made inside; yields their list of (ok, message)."""
    recorded = []
    token = _recorded.set(recorded)
    try:
        yield recorded
    finally:
        _recorded.reset(token)


class Error:
    """
    The outcome of the checks of a checked call: `code` a 0-d int32 device
    tensor, 0 when every check held, else 1 + the index in `messages` of
    the first that failed. Reading it (`get`, `throw`) waits for the device.
    """

    def __init__(self, code, messages):
        self.code = code
        self.messages = list(messages)

    def get(self):
        """The first failed check's message, or None."""
        i = int(self.code) if self.messages else 0
        return self.messages[i - 1] if i else None

    def throw(self):
        """Raise CheckError when a check failed."""
        msg = self.get()
        if msg is not None:
            raise CheckError(msg)


def error(recorded, device):
    """The Error of the recorded (ok, message) pairs, the first failure in
    the order they were recorded; computed on `device`, with no host read."""
    if not recorded:
        return Error(torch.zeros((), dtype=torch.int32, device=device), [])
    oks = torch.stack([ok.to(device) for ok, _ in recorded])
    code = torch.where(oks.all(), 0, (~oks).int().argmax() + 1)
    return Error(code.int(), [m for _, m in recorded])
