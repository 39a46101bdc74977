from repro_torch.smc.decode import SMCDecodeConfig, ess, smc_decode  # noqa: F401
