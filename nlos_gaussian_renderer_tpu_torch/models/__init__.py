"""Scene state and MCMC densification."""

from nlos_gaussian_renderer_tpu_torch.models.densify import compute_relocation, densify_step

__all__ = ["compute_relocation", "densify_step"]
