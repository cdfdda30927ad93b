"""Documentation generator of modal_tpu_torch (port of the JAX package's
`modal_tpu_docs`; reference: py/modal_docs, mdmd-based reference and CLI
doc generation; here a compact inspect-based redesign).

Two generators, both pure introspection so the docs can never drift from
the code:

- `gen_reference_docs(out_dir)`: one markdown file per public API object
  (everything in `modal_tpu_torch.__all__`), with class docstrings,
  public-method signatures and docstrings, the blocking/`.aio` duality
  noted where the synchronizer wrapped a coroutine, and the JAX name of the
  names that `modal_tpu_torch.JAX_NAMES` maps.
- `gen_cli_docs(out_dir)`: one markdown file for the whole CLI tree, walked
  from the live click groups of `modal_tpu_torch/cli/entry_point.py`:
  options, arguments and help text.

Run: `python -m modal_tpu_torch.docs_gen [output_dir]` (defaults to
docs/reference_torch). Neither generator imports torch.
"""

from __future__ import annotations

import inspect
import os
from typing import Any

PACKAGE = "modal_tpu_torch"
CLI_NAME = "modal-tpu-torch"  # the click group's prog name
BAD_STRINGS = ("TODO:",)  # to-dos must not leak into rendered docs


def _signature(obj: Any) -> str:
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _doc(obj: Any) -> str:
    return inspect.getdoc(obj) or ""


def _is_public_member(name: str, member: Any) -> bool:
    if name.startswith("_"):
        return False
    # the synchronizer's wrappers carry their coroutine as `_impl` (the
    # dual blocking/.aio surface)
    if hasattr(member, "_async_func") or hasattr(member, "_impl"):
        return True
    return callable(member) or isinstance(member, property)


def _unwrap(member: Any) -> Any:
    """Reach the underlying async implementation of a dual-surface method so
    the documented signature shows real parameter names."""
    for attr in ("_async_func", "_impl", "__func__", "raw_f"):
        inner = getattr(member, attr, None)
        if inner is not None and callable(inner):
            return inner
    return member


def _render_callable(name: str, member: Any, *, owner: str = "") -> str:
    impl = _unwrap(member)
    dual = impl is not member and inspect.iscoroutinefunction(impl)
    sig = _signature(impl)
    lines = [f"### `{owner + '.' if owner else ''}{name}{sig}`", ""]
    if dual:
        lines.append("_Blocking by default; `.aio` awaits the same call from async code._")
        lines.append("")
    doc = _doc(impl) or _doc(member)
    if doc:
        lines.append(doc)
        lines.append("")
    return "\n".join(lines)


def _heading(name: str) -> str:
    from modal_tpu_torch import JAX_NAMES

    jax_name = {port: jax for jax, port in JAX_NAMES.items()}.get(name)
    head = f"# `{PACKAGE}.{name}`\n\n"
    if jax_name:
        head += f"_The counterpart of `modal_tpu.{jax_name}` in the JAX package._\n\n"
    return head


def _render_class(name: str, cls: type) -> str:
    lines = [_heading(name).rstrip("\n"), ""]
    doc = _doc(cls)
    if doc:
        lines += [doc, ""]
    seen: set[str] = set()
    for klass in cls.__mro__:
        if klass is object:
            continue
        for mname, member in sorted(vars(klass).items()):
            if mname in seen or not _is_public_member(mname, member):
                continue
            seen.add(mname)
            if isinstance(member, property):
                lines.append(f"### `{name}.{mname}` (property)")
                lines.append("")
                pdoc = _doc(member.fget) if member.fget else ""
                if pdoc:
                    lines += [pdoc, ""]
                continue
            if isinstance(member, (classmethod, staticmethod)):
                member = member.__func__
            lines.append(_render_callable(mname, member, owner=name))
    return "\n".join(lines)


def _render_object(name: str, obj: Any) -> str:
    if inspect.isclass(obj):
        return _render_class(name, obj)
    if callable(obj):
        return _heading(name) + _render_callable(name, obj)
    return _heading(name) + f"{_doc(obj)}\n"


def _validate(name: str, text: str) -> str:
    for bad in BAD_STRINGS:
        for line in text.splitlines():
            if bad in line:
                raise ValueError(f"unwanted string {bad!r} leaked into docs for {name}: {line}")
    return text


def gen_reference_docs(out_dir: str) -> list[str]:
    """Render every `modal_tpu_torch.__all__` item to `<out_dir>/<name>.md`
    and an `index.md`; returns the written file paths."""
    import modal_tpu_torch

    os.makedirs(out_dir, exist_ok=True)
    written = []
    index_lines = [f"# {PACKAGE} API reference", ""]
    for name in sorted(modal_tpu_torch.__all__):
        obj = getattr(modal_tpu_torch, name)
        text = _validate(name, _render_object(name, obj))
        path = os.path.join(out_dir, f"{name}.md")
        with open(path, "w") as f:
            f.write(text)
        written.append(path)
        first = _doc(obj).splitlines()[0] if _doc(obj) else ""
        index_lines.append(f"- [`{name}`]({name}.md) — {first}")
    index = os.path.join(out_dir, "index.md")
    with open(index, "w") as f:
        f.write("\n".join(index_lines) + "\n")
    written.append(index)
    return written


def gen_cli_docs(out_dir: str) -> str:
    """Render the whole click CLI tree to `<out_dir>/cli.md`."""
    import click

    from modal_tpu_torch.cli.entry_point import cli

    os.makedirs(out_dir, exist_ok=True)
    lines = [f"# {CLI_NAME} CLI reference", "", f"Run it as `python -m {PACKAGE}.cli`.", ""]

    def _walk(cmd: click.Command, path: str) -> None:
        ctx = click.Context(cmd, info_name=path)
        if isinstance(cmd, click.Group):
            if path != CLI_NAME:
                lines.append(f"## `{path}`")
                lines.append("")
                if cmd.help:
                    lines.extend([cmd.help, ""])
            for sub_name in sorted(cmd.commands):
                _walk(cmd.commands[sub_name], f"{path} {sub_name}")
            return
        usage = " ".join(cmd.collect_usage_pieces(ctx))
        lines.append(f"### `{path} {usage}`" if usage else f"### `{path}`")
        lines.append("")
        if cmd.help:
            lines.extend([cmd.help, ""])
        opts = [p for p in cmd.params if isinstance(p, click.Option)]
        if opts:
            lines.append("Options:")
            for opt in opts:
                decl = ", ".join(opt.opts)
                lines.append(f"- `{decl}` — {opt.help or ''}".rstrip(" —"))
            lines.append("")

    _walk(cli, CLI_NAME)
    path = os.path.join(out_dir, "cli.md")
    with open(path, "w") as f:
        f.write(_validate("cli", "\n".join(lines)) + "\n")
    return path
