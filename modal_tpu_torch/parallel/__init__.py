"""Training (port of modal_tpu/parallel/). `train.py` holds the one-device
train step; meshes, FSDP, pipeline, ring attention and MoE wait for
ROADMAP.md Queue A 5."""
