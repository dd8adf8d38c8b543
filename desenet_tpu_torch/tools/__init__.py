"""Entry points that probe single kernels: ``probe_stem_pallas`` (K5) and
``proto_c3_kernel`` (K6), run as ``python -m desenet_tpu_torch.tools.<name>``.
"""
