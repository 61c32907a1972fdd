"""The port's native code: the host-embedding C ABI
(``fesom2_torch_host.cpp``, the ``f2t_*_`` surface over ``host_embed``),
its demo host (``host_embed_demo.cpp``), the mesh core and CPU golden
reference (``fesom2_torch_core.cpp``, bound by ``mesh/native.py``), their
g++ build (``build``) and what runs the demo on a case (``demo``).
Importing this package compiles nothing."""
