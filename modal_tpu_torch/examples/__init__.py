"""The port's examples, one script each, the counterparts of the JAX
package's `examples/`: a user's first contact with the framework. Each runs
as a script (`python modal_tpu_torch/examples/01_hello_world.py`) against
the zero-config local plane or `MODAL_TPU_SERVER_URL`; those that touch a
tensor run on the card unless their caller asks for the CPU (each file's
docstring says how)."""
