"""The sharded engine on ``torch.distributed`` (``gpu_options(mesh=...)``):
counterpart of ``stateright_tpu/parallel``."""
