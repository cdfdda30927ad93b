"""The port's docs generator (`modal_tpu_torch.docs_gen`) held to the three
cases of tests/test_docs_gen.py, and its page set held to the JAX
generator's under the port's TPU-to-GPU name mapping."""

import os

import pytest

from modal_tpu_torch import JAX_NAMES


def test_reference_docs_cover_public_api(tmp_path):
    import modal_tpu_torch
    from modal_tpu_torch.docs_gen import gen_reference_docs

    out = str(tmp_path / "ref")
    written = gen_reference_docs(out)
    names = {os.path.basename(p)[:-3] for p in written}
    # every public export gets a page, and the index one more
    assert names == {*modal_tpu_torch.__all__, "index"}
    for required in ("App", "Function", "Volume", "Sandbox", "Proxy", "Workspace", "clustered", "GPUSpec"):
        assert required in names, f"missing docs page for {required}"
    fn_doc = open(os.path.join(out, "Function.md")).read()
    assert fn_doc.startswith("# `modal_tpu_torch.Function`")
    assert "Function.remote" in fn_doc or "remote(" in fn_doc
    assert ".aio" in fn_doc, "duality note missing"
    index = open(os.path.join(out, "index.md")).read()
    assert index.startswith("# modal_tpu_torch API reference") and "[`App`](App.md)" in index
    assert "_The counterpart of `modal_tpu.TPUSliceSpec` in the JAX package._" in open(
        os.path.join(out, "GPUSpec.md")).read()


def test_cli_docs_cover_groups(tmp_path):
    from modal_tpu_torch.docs_gen import gen_cli_docs

    path = gen_cli_docs(str(tmp_path))
    text = open(path).read()
    assert "python -m modal_tpu_torch.cli" in text
    for group in ("app", "volume", "proxy", "workspace", "token", "image", "cluster"):
        assert f"## `modal-tpu-torch {group}`" in text, f"missing CLI group {group}"
    assert "modal-tpu-torch run" in text
    assert "Options:" in text


def test_docs_reject_todo_leaks(tmp_path):
    from modal_tpu_torch.docs_gen import _validate

    with pytest.raises(ValueError, match="unwanted string"):
        _validate("x", "fine line\nTODO: oops\n")


def test_the_page_sets_are_the_jax_generators_under_the_mapping(tmp_path):
    """Both generators into tmp_path: the same reference pages (names
    mapped), and a CLI page with the same groups and commands."""
    from modal_tpu_docs import gen_cli_docs as jax_cli
    from modal_tpu_docs import gen_reference_docs as jax_ref
    from modal_tpu_torch.docs_gen import gen_cli_docs, gen_reference_docs

    jax_pages = {os.path.basename(p) for p in jax_ref(str(tmp_path / "jax"))}
    port_pages = {os.path.basename(p) for p in gen_reference_docs(str(tmp_path / "port"))}
    mapped = {JAX_NAMES.get(p[:-3], p[:-3]) + ".md" for p in jax_pages}
    assert port_pages == mapped and len(port_pages) == len(jax_pages)

    def headings(path: str, prog: str) -> list:
        with open(path) as f:
            return [ln.split("`")[1].replace(prog, "PROG").split()[:3] for ln in f if ln.startswith("#") and "`" in ln]

    assert headings(gen_cli_docs(str(tmp_path / "port")), "modal-tpu-torch") == headings(
        jax_cli(str(tmp_path / "jax")), "modal-tpu")
