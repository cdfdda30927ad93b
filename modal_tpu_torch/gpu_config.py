"""`gpu=`: the accelerator a function asks for (port of
modal_tpu/tpu_config.py, in the upstream Modal SDK's terms).

The JAX package resolves `tpu="v5p-64"` into a `TPUConfig` proto (slice
type, topology, mesh hints). The port resolves what the upstream SDK takes
(reference py/modal/gpu.py + api.proto:2506): a free-form GPU type with an
optional count, into a `GPUConfig` proto.

    "H100"         one H100
    "h100:8"       eight H100s (names are case-insensitive)
    "A100-80GB:2"  two A100s with 80 GB each
    "any"          one card of any type

The type names are the ones the upstream SDK documents. A container gets 1
to 8 cards of one host, joined all to all by NVLink, so a spec has no
topology and no hosts beyond one; gangs across hosts come with the port's
gang runtime.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Optional, Union

from .exception import InvalidError
from .proto import api_pb2

# canonical names of the upstream SDK's GPU types
GPU_TYPES = ("T4", "L4", "A10G", "A100", "A100-40GB", "A100-80GB", "L40S", "H100", "H200", "B200")
ANY = "ANY"
MAX_GPUS_PER_HOST = 8


@dataclass(frozen=True)
class GPUSpec:
    gpu_type: str  # canonical: "H100", "A100-80GB", "ANY"
    count: int  # cards per container, 1-8
    mesh: dict[str, int] = field(default_factory=dict)  # user mesh hints (may be empty)

    hosts = 1

    @property
    def gpus_per_host(self) -> int:
        return self.count

    def __str__(self) -> str:
        return self.gpu_type if self.count == 1 else f"{self.gpu_type}:{self.count}"

    def default_mesh(self) -> dict[str, int]:
        """The logical mesh when the user gave no hints: every card on the
        fsdp axis of one host (the JAX package's one-host default)."""
        if self.mesh:
            return dict(self.mesh)
        return {"data": 1, "fsdp": self.count}

    def matches_device(self, device_name: str) -> bool:
        """Whether a card's name (`torch.cuda.get_device_name()`, e.g.
        "NVIDIA H100 80GB HBM3") is of this type: every part of the type
        name appears as a word of it ("A100-80GB" needs "A100" and "80GB";
        "L4" does not match "L40S")."""
        if self.gpu_type == ANY:
            return True
        name = device_name.upper()
        return all(re.search(rf"(?<![A-Z0-9]){re.escape(part)}(?![A-Z0-9])", name)
                   for part in self.gpu_type.split("-"))

    def to_proto(self) -> api_pb2.GPUConfig:
        cfg = api_pb2.GPUConfig(gpu_type=self.gpu_type, count=self.count)
        for k, v in self.mesh.items():
            cfg.mesh[k] = v
        return cfg


def _canonical_type(name: str) -> str:
    upper = name.strip().upper()
    if upper == ANY:
        return ANY
    if upper not in GPU_TYPES:
        raise InvalidError(f"unknown GPU type {name!r}; known: {', '.join(GPU_TYPES)} or 'any'")
    return upper


def parse_gpu_config(
    value: Union[str, GPUSpec, api_pb2.GPUConfig, None],
    mesh: Optional[dict[str, int]] = None,
) -> Optional[GPUSpec]:
    """Parse a `gpu=` argument: "H100", "h100:8", "A100-80GB:2", "any", a
    spec, or a GPUConfig proto."""
    if value is None:
        return None
    if isinstance(value, GPUSpec):
        return value
    if isinstance(value, api_pb2.GPUConfig):
        return from_proto(value)
    if not isinstance(value, str):
        raise InvalidError(f"gpu= must be a string like 'H100' or 'H100:8', got {type(value).__name__}")
    name, _, count_s = value.partition(":")
    if count_s and not count_s.strip().isdigit():
        raise InvalidError(f"invalid GPU count in {value!r}: expected '<type>:<count>' like 'H100:8'")
    count = int(count_s) if count_s else 1
    if not 1 <= count <= MAX_GPUS_PER_HOST:
        raise InvalidError(
            f"GPU count {count} in {value!r} is out of range: a container gets 1 to {MAX_GPUS_PER_HOST} GPUs of one host"
        )
    spec = GPUSpec(gpu_type=_canonical_type(name), count=count, mesh=dict(mesh or {}))
    if mesh:
        mesh_size = math.prod(mesh.values())
        if mesh_size != count:
            raise InvalidError(f"mesh axes {mesh} multiply to {mesh_size}, but {spec} has {count} GPUs")
    return spec


def from_proto(cfg: api_pb2.GPUConfig) -> Optional[GPUSpec]:
    if not cfg.gpu_type:
        return None
    return parse_gpu_config(f"{cfg.gpu_type}:{cfg.count or 1}", dict(cfg.mesh) or None)


def slice_info_proto(spec: GPUSpec) -> api_pb2.GPUSliceInfo:
    """What a gang's containers learn of their placement (the JAX
    package's TPUSliceInfo, here GPUSliceInfo)."""
    info = api_pb2.GPUSliceInfo(gpu_type=spec.gpu_type, num_hosts=spec.hosts, gpus_per_host=spec.gpus_per_host)
    for k, v in spec.default_mesh().items():
        info.default_mesh[k] = v
    return info
