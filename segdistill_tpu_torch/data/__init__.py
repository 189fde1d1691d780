from .device_aug import DeviceAugPipeline, PrepareCanvas

__all__ = ['DeviceAugPipeline', 'PrepareCanvas']
