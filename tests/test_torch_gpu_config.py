"""`gpu=` in the port (`modal_tpu_torch/gpu_config.py`) and its copy of the
wire contract (`modal_tpu_torch/proto/api_pb2.py`) against the JAX
package's (`modal_tpu/tpu_config.py`, `modal_tpu/proto/api_pb2.py`).

Both contracts load into one process (their own file names and proto
packages). For the same field values the shared messages serialize to the
same bytes (compared exactly) and parse across; the port's
`Resources.gpu_config` is an unknown field to the JAX package, never a
`tpu_config`."""

import re

import pytest
from google.protobuf import descriptor_pb2, unknown_fields

from modal_tpu import tpu_config
from modal_tpu.exception import InvalidError as JaxInvalidError
from modal_tpu.proto import api_pb2 as japi
from modal_tpu_torch import gpu_config
from modal_tpu_torch.exception import InvalidError
from modal_tpu_torch.proto import api_pb2 as tapi


@pytest.mark.parametrize("value,gpu_type,count", [
    ("H100", "H100", 1), ("h100:8", "H100", 8), ("A100-80GB:2", "A100-80GB", 2), ("any", "ANY", 1),
    ("l40s:4", "L40S", 4), ("B200:1", "B200", 1), (" t4 ", "T4", 1),
])
def test_parse_and_round_trip_through_the_proto(value, gpu_type, count):
    spec = gpu_config.parse_gpu_config(value)
    assert (spec.gpu_type, spec.count, spec.hosts, spec.gpus_per_host) == (gpu_type, count, 1, count)
    wire = spec.to_proto().SerializeToString()
    assert gpu_config.from_proto(tapi.GPUConfig.FromString(wire)) == spec
    assert gpu_config.parse_gpu_config(spec.to_proto()) == spec
    assert gpu_config.parse_gpu_config(spec) is spec
    assert gpu_config.parse_gpu_config(str(spec)) == spec
    assert spec.default_mesh() == {"data": 1, "fsdp": count}


@pytest.mark.parametrize("value,match", [
    ("H100:9", "1 to 8"), ("H100:0", "1 to 8"), ("X100", "unknown GPU type"), ("H100:two", "invalid GPU count"),
    ("v5p-8", "unknown GPU type"), (8, "must be a string"),
])
def test_errors(value, match):
    with pytest.raises(InvalidError, match=match):
        gpu_config.parse_gpu_config(value)


def test_mesh_hints_must_multiply_to_the_count_as_in_jax():
    spec = gpu_config.parse_gpu_config("H100:8", {"fsdp": 4, "model": 2})
    assert spec.default_mesh() == {"fsdp": 4, "model": 2}
    assert dict(spec.to_proto().mesh) == {"fsdp": 4, "model": 2}
    assert gpu_config.from_proto(spec.to_proto()) == spec
    with pytest.raises(JaxInvalidError) as jexc:
        tpu_config.parse_tpu_config("v5e-8", {"fsdp": 3})
    with pytest.raises(InvalidError) as texc:
        gpu_config.parse_gpu_config("H100:8", {"fsdp": 3})
    pattern = r"mesh axes \{'fsdp': 3\} multiply to 3, but \S+ has 8 (chips|GPUs)"
    assert re.fullmatch(pattern, str(jexc.value)) and re.fullmatch(pattern, str(texc.value))
    assert gpu_config.parse_gpu_config(None) is None
    assert gpu_config.from_proto(tapi.GPUConfig()) is None


def test_slice_info_proto_like_jax():
    spec = gpu_config.parse_gpu_config("h100:4", {"fsdp": 2, "model": 2})
    info = gpu_config.slice_info_proto(spec)
    jinfo = tpu_config.slice_info_proto(tpu_config.parse_tpu_config("v5e-4", {"fsdp": 2, "model": 2}))
    assert dict(info.default_mesh) == dict(jinfo.default_mesh) == {"fsdp": 2, "model": 2}
    assert (info.gpu_type, info.num_hosts, info.gpus_per_host) == ("H100", 1, 4)
    assert (jinfo.num_hosts, jinfo.chips_per_host) == (info.num_hosts, info.gpus_per_host)
    back = tapi.GPUSliceInfo.FromString(info.SerializeToString())
    assert back == info
    assert dict(gpu_config.slice_info_proto(gpu_config.parse_gpu_config("A100:2")).default_mesh) == {
        "data": 1, "fsdp": 2}


@pytest.mark.parametrize("name,gpu,want", [
    ("NVIDIA H100 80GB HBM3", "H100", True), ("NVIDIA H100 80GB HBM3", "H200", False),
    ("NVIDIA A100-SXM4-80GB", "A100-80GB", True), ("NVIDIA A100-SXM4-80GB", "A100-40GB", False),
    ("NVIDIA A100-SXM4-80GB", "A100", True), ("NVIDIA L40S", "L4", False), ("NVIDIA L4", "L4", True),
    ("Tesla T4", "T4", True), ("NVIDIA A10G", "any", True),
])
def test_a_device_name_matches_its_type(name, gpu, want):
    assert gpu_config.parse_gpu_config(gpu).matches_device(name) is want


def test_both_contracts_load_into_one_process_under_their_own_names():
    assert (japi.DESCRIPTOR.name, japi.DESCRIPTOR.package) == ("api.proto", "modal.tpu.api")
    assert (tapi.DESCRIPTOR.name, tapi.DESCRIPTOR.package) == ("modal_tpu_torch/proto/api.proto", "modal.gpu.api")
    jmsgs = japi.DESCRIPTOR.message_types_by_name
    tmsgs = tapi.DESCRIPTOR.message_types_by_name
    assert set(tmsgs) - set(jmsgs) == {"GPUConfig", "GPUSliceInfo"} and set(jmsgs) <= set(tmsgs)
    assert set(tapi.DESCRIPTOR.enum_types_by_name) == set(japi.DESCRIPTOR.enum_types_by_name)
    for name, jmsg in jmsgs.items():  # every field number, type and repetition of the shared contract
        tfields = {f.name: (f.number, f.type, f.is_repeated) for f in tmsgs[name].fields}
        jfields = {f.name: (f.number, f.type, f.is_repeated) for f in jmsg.fields}
        extra = set(tfields) - set(jfields)
        assert {k: tfields[k] for k in jfields} == jfields and extra <= {"gpu_config", "gpu_type", "num_gpus",
                                                                         "gpu_ids", "has_gpu"}, name
    for name, jenum in japi.DESCRIPTOR.enum_types_by_name.items():
        tenum = tapi.DESCRIPTOR.enum_types_by_name[name]
        assert {v.name: v.number for v in tenum.values} == {v.name: v.number for v in jenum.values}


def test_the_proto_text_lists_every_message_of_the_descriptor():
    import os

    import modal_tpu_torch.proto as pkg

    with open(os.path.join(os.path.dirname(pkg.__file__), "api.proto")) as f:
        text = f.read()
    assert set(re.findall(r"^message (\w+)", text, re.M)) == set(tapi.DESCRIPTOR.message_types_by_name)
    assert re.search(r"GPUConfig gpu_config = 7;", text) and "package modal.gpu.api;" in text


def _shared_messages(api):
    return [
        api.FunctionCreateRequest(
            app_id="ap-1", existing_function_id="fu-2",
            function=api.Function(function_name="serve", module_name="app", timeout_secs=300,
                                  enable_memory_snapshot=True),
        ),
        api.Resources(milli_cpu=4000, memory_mb=16384, ephemeral_disk_mb=1024, milli_cpu_max=8000,
                      memory_mb_max=32768),
        api.RetryPolicy(retries=3, backoff_coefficient=2.0, initial_delay_ms=1000, max_delay_ms=60000),
        api.ClientHelloRequest(client_version="0.1.0", client_type=api.CLIENT_TYPE_CONTAINER),
        api.DictUpdateRequest(dict_id="di-1", updates=[api.DictEntry(key=b"k", value=b"v")]),
    ]


@pytest.mark.parametrize("i", range(5))
def test_shared_messages_serialize_to_the_same_bytes(i):
    jmsg, tmsg = _shared_messages(japi)[i], _shared_messages(tapi)[i]
    jb, tb = jmsg.SerializeToString(deterministic=True), tmsg.SerializeToString(deterministic=True)
    assert jb == tb and len(tb) > 0
    assert type(jmsg).FromString(tb) == jmsg and type(tmsg).FromString(jb) == tmsg


def test_the_jax_package_reads_gpu_config_as_an_unknown_field():
    spec = gpu_config.parse_gpu_config("H100:8", {"fsdp": 8})
    res = tapi.Resources(milli_cpu=1000, memory_mb=2048, gpu_config=spec.to_proto())
    jres = japi.Resources.FromString(res.SerializeToString())
    assert not jres.HasField("tpu_config") and (jres.milli_cpu, jres.memory_mb) == (1000, 2048)
    unknown = unknown_fields.UnknownFieldSet(jres)
    assert [(f.field_number, f.wire_type) for f in unknown] == [(7, 2)]
    # kept as unknown bytes, so a JAX relay hands the port its spec intact
    back = tapi.Resources.FromString(jres.SerializeToString())
    assert gpu_config.from_proto(back.gpu_config) == spec
    # and a JAX tpu_config reaches the port as a TPUConfig, its GPUConfig unset
    jtpu = japi.Resources(tpu_config=tpu_config.parse_tpu_config("v5e-4").to_proto())
    tres = tapi.Resources.FromString(jtpu.SerializeToString())
    assert tres.tpu_config.tpu_type == "v5e-4" and not tres.HasField("gpu_config")


def test_regen_is_idempotent_on_the_committed_descriptor(tmp_path, monkeypatch):
    from modal_tpu_torch.proto import regen

    target = tmp_path / "api_pb2.py"
    with open(regen.TARGET) as f:
        committed = f.read()
    target.write_text(committed)
    monkeypatch.setattr(regen, "TARGET", str(target))
    assert regen.regenerate() == []
    assert target.read_text() == committed
    # rebased on the JAX package's descriptor, the result is the committed file
    import modal_tpu.proto as jpkg
    import os

    assert regen.regenerate(os.path.join(os.path.dirname(jpkg.__file__), "api_pb2.py"))[1:] == [
        "file modal_tpu_torch/proto/api.proto, package modal.gpu.api", "+message GPUConfig",
        "+message GPUSliceInfo", "+field Resources.gpu_config = 7", "+field WorkerRegisterRequest.gpu_type = 15",
        "+field WorkerRegisterRequest.num_gpus = 16", "+field TaskAssignment.gpu_ids = 7", "+field TaskInfo.gpu_ids = 13",
        "+field FunctionOptions.gpu_config = 13", "+field FunctionOptions.has_gpu = 14"]
    assert target.read_text() == committed
    fd = descriptor_pb2.FileDescriptorProto.FromString(tapi.DESCRIPTOR.serialized_pb)
    assert not [f.type_name for m in fd.message_type for f in m.field if "modal.tpu.api" in f.type_name]
