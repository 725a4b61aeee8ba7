from repro_torch.data.prefetch import ThreadedPrefetcher  # noqa: F401
