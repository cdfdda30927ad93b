"""Decorator flag algebra for methods and lifecycle hooks (port of
modal_tpu/partial_function.py).

Reference: py/modal/_partial_function.py — `_PartialFunction`
(_partial_function.py:116), `_PartialFunctionFlags` (_partial_function.py:29),
decorators `_method/_enter/_exit/_batched/_concurrent/_clustered`
(_partial_function.py:283,589,617,640,701,780).

A `PartialFunction` wraps a user function inside a class body and records
*how* it should run: as a callable method or a lifecycle hook. The
container runtime reads these flags off a serialized class
(runtime/user_code.py). `@batched` and `@concurrent`, whose parameters the
App writes into the function definition, come with the port's App (ROADMAP
Queue A 4c), as do the web decorators; `@clustered` comes with its gang
runtime (4d).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Callable, Optional

from .exception import InvalidError


class _PartialFunctionFlags(enum.IntFlag):
    FUNCTION = 1
    ENTER_PRE_SNAPSHOT = 2
    ENTER_POST_SNAPSHOT = 4
    EXIT = 8

    @staticmethod
    def all() -> "_PartialFunctionFlags":
        return ~_PartialFunctionFlags(0)


@dataclass
class _PartialFunctionParams:
    is_generator: Optional[bool] = None

    def update(self, other: "_PartialFunctionParams") -> None:
        for f in self.__dataclass_fields__:
            v = getattr(other, f)
            if v is not None and v != self.__dataclass_fields__[f].default:
                setattr(self, f, v)


class _PartialFunction:
    """Intermediate decorator state (reference _partial_function.py:116)."""

    def __init__(
        self,
        raw_f: Callable,
        flags: _PartialFunctionFlags,
        params: Optional[_PartialFunctionParams] = None,
    ):
        self.raw_f = raw_f
        self.flags = flags
        self.params = params or _PartialFunctionParams()
        self.wrapped = False  # set when consumed by @app.cls / @app.function
        self.registered = False

    @property
    def name(self) -> str:
        return self.raw_f.__name__

    def add_flags(self, flags: _PartialFunctionFlags, params: Optional[_PartialFunctionParams] = None):
        import dataclasses

        # The inner partial is consumed by the new one: mark it wrapped so its
        # __del__ doesn't warn, and copy params so stacked decorators don't
        # share mutable state.
        self.wrapped = True
        new = _PartialFunction(self.raw_f, self.flags | flags, dataclasses.replace(self.params))
        if params:
            new.params.update(params)
        return new

    def __get__(self, obj: Any, objtype: Optional[type] = None) -> Any:
        # Accessing an un-wrapped partial method on an instance: return the
        # raw function bound, so local calls still work.
        if obj is None:
            return self
        return self.raw_f.__get__(obj, objtype)

    def __del__(self) -> None:
        if not self.wrapped and not self.registered:
            import warnings

            try:
                warnings.warn(
                    f"method {self.name} was decorated but never attached to an app class"
                )
            except Exception:
                pass


def method(
    _warn_parentheses_missing: Any = None,
    *,
    is_generator: Optional[bool] = None,
) -> Callable[[Callable], _PartialFunction]:
    """Mark an `@app.cls` method as remotely callable (reference
    _partial_function.py:283)."""
    if _warn_parentheses_missing is not None:
        raise InvalidError("Use @modal_tpu_torch.partial_function.method() with parentheses.")

    def wrapper(raw_f: Callable) -> _PartialFunction:
        if isinstance(raw_f, _PartialFunction):
            return raw_f.add_flags(
                _PartialFunctionFlags.FUNCTION, _PartialFunctionParams(is_generator=is_generator)
            )
        return _PartialFunction(
            raw_f, _PartialFunctionFlags.FUNCTION, _PartialFunctionParams(is_generator=is_generator)
        )

    return wrapper


def enter(
    _warn_parentheses_missing: Any = None,
    *,
    snap: bool = False,
) -> Callable:
    """Lifecycle hook run at container start (reference
    _partial_function.py:617). With ``snap=True`` the hook runs *before* the
    warm-state snapshot is taken (weights load etc.), and a boot that
    restores the snapshot skips it (runtime/snapshot.py)."""
    if _warn_parentheses_missing is not None:
        raise InvalidError("Use @modal_tpu_torch.partial_function.enter() with parentheses.")
    flag = _PartialFunctionFlags.ENTER_PRE_SNAPSHOT if snap else _PartialFunctionFlags.ENTER_POST_SNAPSHOT

    def wrapper(raw_f: Callable):
        if isinstance(raw_f, _PartialFunction):
            return raw_f.add_flags(flag)
        return _PartialFunction(raw_f, flag)

    return wrapper


def exit(_warn_parentheses_missing: Any = None) -> Callable:  # noqa: A001
    """Lifecycle hook run at container shutdown (reference
    _partial_function.py:640)."""
    if _warn_parentheses_missing is not None:
        raise InvalidError("Use @modal_tpu_torch.partial_function.exit() with parentheses.")

    def wrapper(raw_f: Callable):
        if isinstance(raw_f, _PartialFunction):
            return raw_f.add_flags(_PartialFunctionFlags.EXIT)
        return _PartialFunction(raw_f, _PartialFunctionFlags.EXIT)

    return wrapper


def find_partial_methods_for_user_cls(user_cls: type, flags: int) -> dict[str, _PartialFunction]:
    """Grab all partial methods matching `flags` from a user class body
    (reference _partial_function.py find_partial_methods_for_user_cls)."""
    out: dict[str, _PartialFunction] = {}
    for parent_cls in reversed(user_cls.__mro__):
        if parent_cls is object:
            continue
        for k, v in vars(parent_cls).items():
            if isinstance(v, _PartialFunction) and (v.flags & flags):
                v.registered = True
                out[k] = v
    return out


def find_callables_for_obj(user_obj: Any, flags: int) -> dict[str, Callable]:
    """Bound callables for lifecycle hook execution."""
    user_cls = type(user_obj)
    return {
        k: pf.raw_f.__get__(user_obj)
        for k, pf in find_partial_methods_for_user_cls(user_cls, flags).items()
    }
