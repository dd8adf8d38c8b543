"""Entry points that probe, profile and time the kernels, run as ``python -m
desenet_tpu_torch.tools.<name>``: ``probe_stem_pallas`` (K5) and
``proto_c3_kernel`` (K6), the profilers ``profile_served``,
``profile_seg_head`` (K4) and ``profile_c3_phases`` (K6), ``mma_peak`` (the
card's ``mma.sync`` ceiling); ``timing`` holds the timers and the kernels'
bounds.
"""
