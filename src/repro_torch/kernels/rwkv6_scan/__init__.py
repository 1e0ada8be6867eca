from repro_torch.kernels.rwkv6_scan.ops import wkv, wkv_plain  # noqa: F401
