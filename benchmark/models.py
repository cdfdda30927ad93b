"""A configuration file (`benchmark/configs/<name>.json`): the model's
published `config.json` keys, with `reduced` naming each key changed from
the published value and `assumed` each size the source does not give.

`Model` holds what the harness and the reference read; `llama_config`
maps it onto the program's `LlamaConfig`, the one place that knows the
program's field names."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class Model:
    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    rms_norm_eps: float
    rope_theta: float
    max_position_embeddings: int
    torch_dtype: str
    initializer_range: float

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.torch_dtype]

    @property
    def params(self) -> int:
        """Every weight: embedding, layers, final norm and output head."""
        d, hd = self.hidden_size, self.head_dim
        attn = d * self.num_attention_heads * hd * 2 + d * self.num_key_value_heads * hd * 2
        layer = attn + 3 * d * self.intermediate_size + 2 * d
        return 2 * self.vocab_size * d + self.num_hidden_layers * layer + d

    @property
    def kv_bytes_per_token(self) -> int:
        """K and V of one token in one layer, in the served dtype."""
        return 2 * self.num_key_value_heads * self.head_dim * torch.tensor([], dtype=self.dtype).element_size()


# the published keys this decoder serves only at these values
REQUIRED = {"hidden_act": "silu", "tie_word_embeddings": False}
UNSUPPORTED_IF_SET = ("sliding_window", "rope_scaling")


def load(path: Path) -> tuple[Model, dict]:
    """(Model, the raw file). Raises ValueError for a configuration this
    decoder cannot run as published."""
    raw = json.loads(Path(path).read_text())
    for key, want in REQUIRED.items():
        if raw.get(key, want) != want:
            raise ValueError(f"{path}: {key}={raw[key]!r}; this decoder runs {want!r} only")
    for key in UNSUPPORTED_IF_SET:
        if raw.get(key) is not None:
            raise ValueError(f"{path}: {key} is set; this decoder has no such mechanism")
    fields = {f.name for f in dataclasses.fields(Model)}
    model = Model(**{k: raw[k] for k in fields})
    if model.hidden_size % model.num_attention_heads or model.num_attention_heads % model.num_key_value_heads:
        raise ValueError(f"{path}: heads do not divide the width")
    return model, raw


def llama_config(model: Model):
    """The program's configuration object for `model`."""
    from modal_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        name=model.name, vocab_size=model.vocab_size, dim=model.hidden_size,
        n_layers=model.num_hidden_layers, n_heads=model.num_attention_heads,
        n_kv_heads=model.num_key_value_heads, ffn_dim=model.intermediate_size,
        norm_eps=model.rms_norm_eps, rope_theta=float(model.rope_theta),
        max_seq_len=model.max_position_embeddings, dtype=model.dtype,
    )
