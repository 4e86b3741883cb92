from jeicyboodsp_tpu_torch.pipelines.registry import PIPELINES  # noqa: F401
