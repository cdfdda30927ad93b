"""The command line of modal_tpu_torch: `python -m modal_tpu_torch.cli`
(`entry_point.py`, the JAX package's command tree with `--gpu` for
`--tpu`), and the resolution of an import reference such as
"file.py::app" (`import_refs.py`) that `run`, `deploy`, `serve` and the hot
reload's subprocess go through. `lint` runs the port's static analysis
(`modal_tpu_torch/analysis/`) over the package."""
