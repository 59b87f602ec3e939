from .nms import cpu_nms, is_available, oks_nms_native, soft_oks_nms_native
