from grlir_torch.losses.pixel import (
    LOSS_FNS,
    charbonnier_loss,
    l1_loss,
    mse_loss,
    tv_loss,
    weighted_loss,
)

__all__ = ["LOSS_FNS", "charbonnier_loss", "l1_loss", "mse_loss", "tv_loss",
           "weighted_loss"]
