"""The w4 design probes on the card (port of ``tools/kernel_bench.py`` and
``tools/w4_probe.py``).

    python -m llmc_tpu_torch.tools.kernel_bench
    python -m llmc_tpu_torch.tools.w4_probe

Each times B1's mma.sync design (``w4_current``), the library's bf16
GEMM and the probe kernels of ``ops/probe_gemm.py`` at the JAX tools'
gate_up shape, one JSON line a variant with ``ms``, ``bound_ms``,
``bound_by``, the plain version's time and error and, where one PyTorch
call computes the same function, ``library_ms``.  ``run(device=None, ...)``
returns the records: without a card it raises unless ``device='cpu'`` is
passed, and then it runs the plain versions and times nothing.

Two more tools read the card only:

    python -m llmc_tpu_torch.tools.wgmma_variants
    python -m llmc_tpu_torch.tools.ab_serve TREE_A TREE_B

``wgmma_variants`` times B1 and B4 as built beside copies with their
decode or their wgmma cut; ``ab_serve`` times the serving phases of two
checkouts in turns.
"""
