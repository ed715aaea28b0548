from nlos_gaussian_renderer_tpu_torch.configs.default import Config, OptimizationParams

__all__ = ["Config", "OptimizationParams"]
