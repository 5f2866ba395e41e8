from bsmr_sddmm_tpu_torch.utils.checkdata import check_data, CheckResult
from bsmr_sddmm_tpu_torch.utils.logger import RunLog
from bsmr_sddmm_tpu_torch.utils.timing import time_cuda, time_host

__all__ = ["check_data", "CheckResult", "RunLog", "time_cuda", "time_host"]
