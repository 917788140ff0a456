from fastedit_tpu_torch.ops.attention import attention  # noqa: F401
from fastedit_tpu_torch.ops.conv import conv3x3_same  # noqa: F401
from fastedit_tpu_torch.ops.groupnorm import group_norm  # noqa: F401
from fastedit_tpu_torch.ops import flags  # noqa: F401
