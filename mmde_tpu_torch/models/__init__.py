from mmde_tpu_torch.models.two_frame import (  # noqa: F401
    SWIN_VARIANTS, BuildPlan, TwoFrameDepthPose, build_model, build_plan,
    resolve_attn_impl)
