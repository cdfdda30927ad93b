"""The part of the JAX package's CLI the port needs so far: resolving an
import reference such as "file.py::app" (`import_refs.py`), which the hot
reload's subprocess deploys by. The commands themselves come with ROADMAP
Queue A 4e."""
