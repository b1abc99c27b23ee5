from .adversarial import (acgan_aux_loss, bce_d_loss, bce_g_loss, hinge_d_loss,
                          hinge_g_loss, l1_loss, wgan_d_loss, wgan_g_loss)
from .gradient_penalty import drift_penalty, gradient_penalty

__all__ = ["acgan_aux_loss", "bce_d_loss", "bce_g_loss", "drift_penalty",
           "gradient_penalty", "hinge_d_loss", "hinge_g_loss", "l1_loss",
           "wgan_d_loss", "wgan_g_loss"]
