"""The port's demo: `python -m awsm_renderer_tpu_torch.demo.app`."""
