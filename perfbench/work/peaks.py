"""Published peaks of the cards the benchmark runs on (dense rates, no
sparsity), from NVIDIA's data sheets.  A share of a roofline or of a peak is
stated against these, with the card's power limit beside it."""

# device name as torch.cuda.get_device_name() gives it -> its peaks
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "bf16_flops_per_s": 989e12,
                              "f32_flops_per_s": 67e12},
}


def peaks(device_name: str) -> dict:
    """The peaks of ``device_name``; raises for a card the table lacks, so
    that no share is stated against another card's peaks."""
    if device_name not in PEAKS:
        raise KeyError(f"no published peaks for {device_name!r}; add the card to PEAKS")
    return PEAKS[device_name]
