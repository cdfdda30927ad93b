"""Exception hierarchy of the port: the JAX package's class names and bases
(modal_tpu/exception.py; reference: py/modal/exception.py)."""


class Error(Exception):
    """Base class for all errors of the port."""


class RemoteError(Error):
    """An error on the server or in the remote function."""


class ExecutionError(Error):
    """Internal error in the client or runtime."""


class InvalidError(Error):
    """The user did something invalid (bad argument combination, misuse)."""


class NotFoundError(Error):
    """A referenced object (app, function, volume, ...) does not exist."""


class AlreadyExistsError(Error):
    """An object with this name already exists and overwrite was disallowed."""


class VersionError(Error):
    """Client/server version skew."""


import builtins as _builtins


class TimeoutError(Error, _builtins.TimeoutError):  # noqa: A001 — mirrors reference naming
    """Base timeout. Subclasses builtins.TimeoutError so both
    `except modal_tpu_torch.exception.TimeoutError` and `except TimeoutError` catch it."""


class FunctionTimeoutError(TimeoutError):
    """The remote function exceeded its `timeout`."""


class SandboxTimeoutError(TimeoutError):
    """The sandbox exceeded its lifetime."""


class SandboxTerminatedError(Error):
    """The sandbox was terminated externally."""


class OutputExpiredError(TimeoutError):
    """Function call output is past its retention window."""


class ConnectionError(Error):  # noqa: A001
    """Could not reach the control plane."""


class AuthError(Error):
    """Bad or missing credentials."""


class DeserializationError(Error):
    """Payload could not be deserialized (usually version/environment skew)."""


class SerializationError(Error):
    """Object could not be serialized for transport."""


class RequestSizeError(Error):
    """Inline request exceeded the wire size limit."""


class DeprecationError(UserWarning):
    """Deprecated API usage (raised, like the reference, when hard-removed)."""


class PendingDeprecationError(UserWarning):
    """Pre-deprecation warning."""


class ClusterError(Error):
    """Gang scheduling / cluster rendezvous failure."""


class InputCancellation(BaseException):
    """Raised inside user code when the current input is cancelled.

    BaseException so that ordinary `except Exception` in user code doesn't
    swallow it (reference: modal.exception.InputCancellation).
    """


class ClientClosed(Error):
    """Operation on a closed client."""


def simulate_preemption(*a, **kw):  # placeholder for parity with reference API
    raise NotImplementedError("simulate_preemption is not supported yet")
