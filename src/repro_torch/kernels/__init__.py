"""Plain PyTorch versions and hand-written Hopper kernels of the hot paths.

``lut_dense.py``       kernel B2, the eval LUT-Dense forward
                       (``csrc/lut_dense.cu``).
``lut_serve.py``       the integer serving engine: fused stage composition,
                       the torch fused runner, ``verify_engine``.
``lut_serve_cuda.py``  kernel B4, the whole packed stage chain in one launch
                       (``csrc/lut_serve.cu``).
``ops.py``             the eval ``lut_dense`` entry point and the launch
                       counters.
``ref.py``             the plain versions the kernels are held against.
``build.py``           compiles ``csrc/*.cu`` with ``nvcc`` at first use.

Each wrapper takes its plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or raises.
"""
