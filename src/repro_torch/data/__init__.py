from repro_torch.data.tasks import BOS, EOS, PAD

__all__ = ["PAD", "BOS", "EOS"]
