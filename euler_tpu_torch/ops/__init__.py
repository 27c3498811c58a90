"""Graph ops of the port: host alias builders, sampling, feature lookup
and the hand-written kernels' wrappers."""
from euler_tpu_torch.ops import ell_agg as _ell_agg
from euler_tpu_torch.ops import ell_attn as _ell_attn
from euler_tpu_torch.ops import fan_draw as _fan_draw
from euler_tpu_torch.ops import gather_rows as _gather_rows
from euler_tpu_torch.ops import rel_agg as _rel_agg
from euler_tpu_torch.ops import sigmoid_xent as _sigmoid_xent

#: the kernel wrappers; each adds one to its ``.launches`` where it
#: launches its kernel (``_build.launch``), and nowhere else
COUNTED = (_fan_draw.fan_draw, _gather_rows.gather_rows, _ell_agg.ell_agg,
           _ell_attn.ell_sddmm, _ell_attn.ell_gat, _rel_agg.rel_mean,
           _rel_agg.rel_mean_tr, _sigmoid_xent.sigmoid_xent)
