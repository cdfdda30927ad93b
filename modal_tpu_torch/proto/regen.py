"""Regenerate `api_pb2.py` of the port without protoc.

`api_pb2.py` holds the port's wire contract as a serialized
FileDescriptorProto. There is no protoc or grpcio-tools to compile
`api.proto`, so this tool edits the descriptor itself (the counterpart of
the JAX package's `tools/patch_descriptor.py`):

1. read the serialized descriptor out of the current `api_pb2.py` (parsed
   as source, never imported: a broken file can still be regenerated), or,
   with ``--rebase PATH``, out of another `api_pb2.py`, such as the JAX
   package's `modal_tpu/proto/api_pb2.py`, to take its messages;
2. give it the port's file name and proto package (`FILE_NAME`, `PACKAGE`),
   renaming every type reference, so both contracts load into one process's
   default descriptor pool; message names and field numbers, which are
   what travels on the wire, stay;
3. apply `NEW_MESSAGES` and `NEW_FIELDS` (idempotent: what is already there
   is checked, not added twice);
4. check that the result builds in a fresh descriptor pool, then rewrite
   `api_pb2.py` around it.

`api.proto` stays the readable source; keep it in step with the two tables.

    python -m modal_tpu_torch.proto.regen
    python -m modal_tpu_torch.proto.regen --rebase modal_tpu/proto/api_pb2.py
"""

from __future__ import annotations

import argparse
import ast
import os

from google.protobuf import descriptor_pb2, descriptor_pool

F = descriptor_pb2.FieldDescriptorProto

HERE = os.path.dirname(os.path.abspath(__file__))
TARGET = os.path.join(HERE, "api_pb2.py")
FILE_NAME = "modal_tpu_torch/proto/api.proto"
PACKAGE = "modal.gpu.api"
MODULE = "modal_tpu_torch.proto.api_pb2"

# name -> (insert after this message, [(field, number, type, label, type_name)],
# {nested map-entry name: (key type, value type)}); type_name without the
# package, for TYPE_MESSAGE fields
NEW_MESSAGES: dict[str, tuple[str, list[tuple[str, int, int, int, str]], dict[str, tuple[int, int]]]] = {
    # the upstream SDK's accelerator request (reference api.proto:2506): a
    # free-form type string and a count, plus the mesh hints TPUConfig has
    "GPUConfig": (
        "TPUConfig",
        [
            ("gpu_type", 1, F.TYPE_STRING, F.LABEL_OPTIONAL, ""),
            ("count", 2, F.TYPE_UINT32, F.LABEL_OPTIONAL, ""),
            ("mesh", 3, F.TYPE_MESSAGE, F.LABEL_REPEATED, "GPUConfig.MeshEntry"),
        ],
        {"MeshEntry": (F.TYPE_STRING, F.TYPE_UINT32)},
    ),
    # what a gang's containers learn of their placement (TPUSliceInfo's
    # counterpart: one host of 1-8 GPUs, NVLink all to all, no torus)
    "GPUSliceInfo": (
        "TPUSliceInfo",
        [
            ("gpu_type", 1, F.TYPE_STRING, F.LABEL_OPTIONAL, ""),
            ("num_hosts", 3, F.TYPE_UINT32, F.LABEL_OPTIONAL, ""),
            ("gpus_per_host", 4, F.TYPE_UINT32, F.LABEL_OPTIONAL, ""),
            ("host_addresses", 5, F.TYPE_STRING, F.LABEL_REPEATED, ""),
            ("default_mesh", 6, F.TYPE_MESSAGE, F.LABEL_REPEATED, "GPUSliceInfo.DefaultMeshEntry"),
        ],
        {"DefaultMeshEntry": (F.TYPE_STRING, F.TYPE_UINT32)},
    ),
}

# (message, field, number, type, label, type_name): fields added to messages
# of the shared contract. A new number, never a TPU field's: a JAX server
# must read the port's gpu_config as an unknown field, not as a tpu_config
NEW_FIELDS: list[tuple[str, str, int, int, int, str]] = [
    ("Resources", "gpu_config", 7, F.TYPE_MESSAGE, F.LABEL_OPTIONAL, "GPUConfig"),
    # a worker's card inventory and the cards pinned to a task: beside the
    # TPU fields, never in their place, so a JAX control plane reads a port
    # worker's cards as unknown fields and never as chips
    ("WorkerRegisterRequest", "gpu_type", 15, F.TYPE_STRING, F.LABEL_OPTIONAL, ""),
    ("WorkerRegisterRequest", "num_gpus", 16, F.TYPE_UINT32, F.LABEL_OPTIONAL, ""),
    ("TaskAssignment", "gpu_ids", 7, F.TYPE_UINT32, F.LABEL_REPEATED, ""),
    ("TaskInfo", "gpu_ids", 13, F.TYPE_UINT32, F.LABEL_REPEATED, ""),
]


def _blob_of(path: str) -> bytes:
    """The bytes literal passed to AddSerializedFile in an api_pb2.py."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "AddSerializedFile"
                and node.args and isinstance(node.args[0], ast.Constant)):
            return node.args[0].value
    raise SystemExit(f"{path}: no AddSerializedFile(b'...') call")


def _rename_package(fd: descriptor_pb2.FileDescriptorProto) -> None:
    old = "." + fd.package + "."
    new = "." + PACKAGE + "."

    def fix(msg: descriptor_pb2.DescriptorProto) -> None:
        for field in msg.field:
            if field.type_name.startswith(old):
                field.type_name = new + field.type_name[len(old):]
        for nested in msg.nested_type:
            fix(nested)

    for msg in fd.message_type:
        fix(msg)
    for svc in fd.service:
        for method in svc.method:
            method.input_type = method.input_type.replace(old, new, 1)
            method.output_type = method.output_type.replace(old, new, 1)
    fd.name = FILE_NAME
    fd.package = PACKAGE


def _field(name: str, number: int, ftype: int, label: int, type_name: str) -> F:
    f = F(name=name, number=number, type=ftype, label=label, json_name=_json_name(name))
    if type_name:
        f.type_name = f".{PACKAGE}.{type_name}"
    return f


def _json_name(name: str) -> str:
    head, *rest = name.split("_")
    return head + "".join(p[:1].upper() + p[1:] for p in rest)


def _check_fields(msg: descriptor_pb2.DescriptorProto, fields) -> None:
    have = {f.name: f for f in msg.field}
    for name, number, ftype, label, _type_name in fields:
        f = have.get(name)
        if f is None or (f.number, f.type, f.label) != (number, ftype, label):
            raise SystemExit(f"{msg.name}.{name} exists with another number, type or label")


def _apply_patches(fd: descriptor_pb2.FileDescriptorProto) -> list[str]:
    changed = []
    for name, (after, fields, maps) in NEW_MESSAGES.items():
        existing = next((m for m in fd.message_type if m.name == name), None)
        if existing is not None:
            _check_fields(existing, fields)
            continue
        msg = descriptor_pb2.DescriptorProto(name=name)
        msg.field.extend(_field(*spec) for spec in fields)
        for entry, (ktype, vtype) in maps.items():
            nested = msg.nested_type.add(name=entry)
            nested.field.extend([_field("key", 1, ktype, F.LABEL_OPTIONAL, ""),
                                 _field("value", 2, vtype, F.LABEL_OPTIONAL, "")])
            nested.options.map_entry = True
        at = next(i for i, m in enumerate(fd.message_type) if m.name == after) + 1
        rest = list(fd.message_type[at:])
        del fd.message_type[at:]
        fd.message_type.extend([msg, *rest])
        changed.append(f"+message {name}")
    for msg_name, name, number, ftype, label, type_name in NEW_FIELDS:
        msg = next(m for m in fd.message_type if m.name == msg_name)
        if any(f.name == name for f in msg.field):
            _check_fields(msg, [(name, number, ftype, label, type_name)])
            continue
        if any(f.number == number for f in msg.field):
            raise SystemExit(f"{msg_name}: field number {number} is taken")
        msg.field.append(_field(name, number, ftype, label, type_name))
        changed.append(f"+field {msg_name}.{name} = {number}")
    return changed


def _render(blob: bytes) -> str:
    return (
        "# -*- coding: utf-8 -*-\n"
        "# Generated by modal_tpu_torch/proto/regen.py (protoc's layout).  DO NOT EDIT!\n"
        f"# source: {FILE_NAME}\n"
        '"""Generated protocol buffer code."""\n'
        "from google.protobuf.internal import builder as _builder\n"
        "from google.protobuf import descriptor as _descriptor\n"
        "from google.protobuf import descriptor_pool as _descriptor_pool\n"
        "from google.protobuf import symbol_database as _symbol_database\n"
        "# @@protoc_insertion_point(imports)\n\n"
        "_sym_db = _symbol_database.Default()\n\n\n"
        f"DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile({blob!r})\n\n"
        "_globals = globals()\n"
        "_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, _globals)\n"
        f"_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, {MODULE!r}, _globals)\n"
        "# @@protoc_insertion_point(module_scope)\n"
    )


def regenerate(rebase: str = "") -> list[str]:
    fd = descriptor_pb2.FileDescriptorProto.FromString(_blob_of(rebase or TARGET))
    changed = [f"rebased on {rebase}"] if rebase else []
    if fd.package != PACKAGE or fd.name != FILE_NAME:
        _rename_package(fd)
        changed.append(f"file {FILE_NAME}, package {PACKAGE}")
    changed += _apply_patches(fd)
    blob = fd.SerializeToString(deterministic=True)
    descriptor_pool.DescriptorPool().Add(fd)  # raises on a malformed descriptor
    with open(TARGET, "w") as f:
        f.write(_render(blob))
    return changed


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rebase", default="", help="take the messages from this api_pb2.py")
    args = ap.parse_args()
    changed = regenerate(args.rebase)
    print(f"{TARGET}: " + ("; ".join(changed) if changed else "up to date"))


if __name__ == "__main__":
    main()
