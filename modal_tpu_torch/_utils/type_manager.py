"""Typed class-parameter serde (port of modal_tpu/_utils/type_manager.py;
reference py/modal/_type_manager.py:20).

Classes that declare `x: int = modal_tpu_torch.parameter()` fields get a typed
proto schema (`ClassParameterInfo` with CLASS_PARAM_FORMAT_PROTO) instead of
pickled constructor args — the cross-SDK half of serialization parity: a Go/
JS client can bind an instance by sending a `ClassParameterSet`, no Python
pickle involved.

Own design: a flat serde table keyed by python type and ParameterType (the
reference builds a decorator-registered ProtoParameterSerdeRegistry; the
table here is small enough to be explicit).
"""

from __future__ import annotations

from typing import Any

from ..exception import InvalidError
from ..proto import api_pb2

# python type -> (ParameterType, value oneof field, default oneof field)
_PY_TO_PROTO: dict[type, tuple[int, str, str]] = {
    str: (api_pb2.PARAM_TYPE_STRING, "string_value", "string_default"),
    int: (api_pb2.PARAM_TYPE_INT, "int_value", "int_default"),
    bytes: (api_pb2.PARAM_TYPE_BYTES, "bytes_value", "bytes_default"),
    bool: (api_pb2.PARAM_TYPE_BOOL, "bool_value", "bool_default"),
    float: (api_pb2.PARAM_TYPE_FLOAT, "float_value", "float_default"),
}

_PROTO_TO_FIELD: dict[int, str] = {
    api_pb2.PARAM_TYPE_STRING: "string_value",
    api_pb2.PARAM_TYPE_INT: "int_value",
    api_pb2.PARAM_TYPE_BYTES: "bytes_value",
    api_pb2.PARAM_TYPE_BOOL: "bool_value",
    api_pb2.PARAM_TYPE_FLOAT: "float_value",
}

SUPPORTED_TYPES = tuple(_PY_TO_PROTO)


def parameter_type_for(annotation: type) -> int:
    if annotation not in _PY_TO_PROTO:
        names = ", ".join(t.__name__ for t in _PY_TO_PROTO)
        raise InvalidError(
            f"modal_tpu_torch.parameter() fields must be annotated with one of [{names}]; "
            f"got {getattr(annotation, '__name__', annotation)!r}"
        )
    return _PY_TO_PROTO[annotation][0]


def _check_type(name: str, value: Any, param_type: int) -> None:
    for py_type, (proto_type, _, _) in _PY_TO_PROTO.items():
        if proto_type == param_type:
            # bool is an int subclass: require exact match for both
            if type(value) is not py_type:
                raise InvalidError(
                    f"parameter {name!r} expects {py_type.__name__}, "
                    f"got {type(value).__name__}"
                )
            return
    raise InvalidError(f"parameter {name!r} has unsupported type id {param_type}")


def build_schema(fields: list[tuple[str, type, bool, Any]]) -> list[api_pb2.ClassParameterSpec]:
    """[(name, annotation, has_default, default)] -> proto schema."""
    schema = []
    for name, annotation, has_default, default in fields:
        param_type, _, default_field = _PY_TO_PROTO[annotation]
        spec = api_pb2.ClassParameterSpec(name=name, type=param_type, has_default=has_default)
        if has_default:
            _check_type(name, default, param_type)
            setattr(spec, default_field, default)
        schema.append(spec)
    return schema


def encode_parameter_set(
    schema: list[api_pb2.ClassParameterSpec], kwargs: dict[str, Any]
) -> bytes:
    """Validate kwargs against the schema and encode a ClassParameterSet."""
    by_name = {spec.name: spec for spec in schema}
    unknown = set(kwargs) - set(by_name)
    if unknown:
        raise InvalidError(f"unknown parameter(s) {sorted(unknown)}; schema has {sorted(by_name)}")
    out = api_pb2.ClassParameterSet()
    for spec in schema:
        if spec.name in kwargs:
            value = kwargs[spec.name]
        elif spec.has_default:
            continue  # container applies the schema default
        else:
            raise InvalidError(f"missing required parameter {spec.name!r}")
        _check_type(spec.name, value, spec.type)
        pv = out.parameters.add()
        pv.name = spec.name
        pv.type = spec.type
        setattr(pv, _PROTO_TO_FIELD[spec.type], value)
    return out.SerializeToString()


def decode_parameter_set(
    data: bytes, schema: list[api_pb2.ClassParameterSpec]
) -> dict[str, Any]:
    """ClassParameterSet bytes -> kwargs, schema defaults applied."""
    param_set = api_pb2.ClassParameterSet.FromString(data) if data else api_pb2.ClassParameterSet()
    kwargs: dict[str, Any] = {}
    for pv in param_set.parameters:
        field = pv.WhichOneof("value_oneof")
        if field is None:
            raise InvalidError(f"parameter {pv.name!r} carries no value")
        kwargs[pv.name] = getattr(pv, field)
    for spec in schema:
        if spec.name not in kwargs:
            if not spec.has_default:
                raise InvalidError(f"missing required parameter {spec.name!r}")
            default_field = spec.WhichOneof("default_oneof")
            kwargs[spec.name] = getattr(spec, default_field) if default_field else None
    return kwargs
