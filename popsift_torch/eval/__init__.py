"""Accuracy evaluation: repeatability and matching score of image pairs
(:mod:`.repeatability`), the Oxford-shaped protocol (:mod:`.oxford`) and
the reference script's output tree (:mod:`.parity`)."""


def no_device_reason(device: str) -> str | None:
    """Why extraction cannot run on ``device`` here, or None: a CUDA
    device where none is available (the accuracy tools take --device cpu
    for the plain PyTorch versions)."""
    import torch
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        return (f"--device {device}: no CUDA device is available; pass "
                f"--device cpu to run the plain PyTorch versions")
    return None
