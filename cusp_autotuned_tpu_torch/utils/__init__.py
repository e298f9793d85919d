from cusp_autotuned_tpu_torch.utils.exceptions import (
    CuspException, FormatException, FormatConversionException,
    NotImplementedException, InvalidInputException, IOException,
    RuntimeException,
)
from cusp_autotuned_tpu_torch.utils.padding import LANE, round_up, pad_to
from cusp_autotuned_tpu_torch.utils.config import (
    configure, get_config, plan_value_dtype, resolve_device,
)
