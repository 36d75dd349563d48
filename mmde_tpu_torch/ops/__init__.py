from mmde_tpu_torch.ops.window_attention import (  # noqa: F401
    MAX_LOGIT_SCALE, cosine_window_attention, scaled_window_attention)
from mmde_tpu_torch.ops.window_attention_headsplit import (  # noqa: F401
    cosine_window_attention_headsplit,
    cosine_window_attention_headsplit_plain)
from mmde_tpu_torch.ops.window_attention_packed import (  # noqa: F401
    cosine_window_attention_packed, cosine_window_attention_packed_plain)
