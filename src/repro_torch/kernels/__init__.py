"""Plain PyTorch versions and hand-written Hopper kernels of the hot paths.

``fake_quant.py``      kernel B1, element-wise fake-quant
                       (``csrc/fake_quant.cu``).
``lut_dense.py``       kernel B2, the LUT-Dense forward
                       (``csrc/lut_dense.cu``).
``lut_dense_bwd.py``   kernel B3, its recompute backward
                       (``csrc/lut_dense_bwd.cu``).
``lut_serve.py``       the integer serving engine: fused stage composition,
                       the torch fused runner, ``verify_engine``.
``lut_serve_cuda.py``  kernel B4, the whole packed stage chain in one launch
                       (``csrc/lut_serve.cu``).
``ops.py``             ``lut_dense`` (B2 forward, B3 backward as one
                       ``autograd.Function``), ``lut_dense_train``,
                       ``fake_quant`` and the launch counters.
``ref.py``             the plain versions the kernels are held against.
``build.py``           compiles ``csrc/*.cu`` (with the shared quantizer grid
                       ``csrc/fq.cuh``) with ``nvcc`` at first use.

Each wrapper takes its plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or raises.
"""
