"""Flag defaults, the flat YAML overlay and gin-lite bindings.

The port's own copy of what it needs from samplenerfro_tpu/utils/config.py
and utils/gin_lite.py: the same flag names and defaults, the
`configs/**/*.yaml` overlay (flat `key: scalar` lines, read here without a
YAML package) and the `Class.param = literal` gin subset.

Flags the port reads and ignores are IGNORED_FLAGS, each with its reason:
they tune the TPU kernels' VMEM windows, interpolation precision,
free-space skip and marcher choice. The Hopper march
kernels gather straight from the grid in device memory and interpolate in
fp32, so none of them applies.
"""

import ast
import dataclasses
import types

FLAG_DEFAULTS = {
    "gin_file": None, "gin_param": None, "train_dir": None,
    "stage_dir": None, "data_dir": None, "config": None,
    "dataset": "blender", "batching": "single_image", "white_bkgd": True,
    "batch_size": 1024, "factor": 4, "spherify": False,
    "render_path": False, "llffhold": 8, "use_pixel_centers": False,
    "stage": "radiance", "skip_frames": 1, "model": "nerf", "near": 2.0,
    "far": 6.0, "net_depth": 8, "net_width": 256, "net_depth_condition": 1,
    "net_width_condition": 128, "weight_decay_mult": 0.0, "skip_layer": 4,
    "num_rgb_channels": 3, "num_sigma_channels": 1, "randomized": True,
    "min_deg_point": 0, "max_deg_point": 10, "deg_view": 4,
    "num_coarse_samples": 64, "num_fine_samples": 128, "use_viewdirs": True,
    "sh_deg": -1, "sh_direnc_deg": -1, "noise_std": None, "lindisp": False,
    "net_activation": "relu", "rgb_activation": "sigmoid",
    "sigma_activation": "softplus", "legacy_posenc_order": False,
    "lr_init": 0.0005, "lr_final": 5e-06, "lr_delay_steps": 2500,
    "lr_delay_mult": 0.01, "grad_max_norm": 0.0, "grad_max_val": 0.0,
    "max_steps": 1000000, "save_every": 10000, "print_every": 100,
    "render_every": 5000, "gc_every": 10000, "steps_per_dispatch": 1,
    "render_chunks_per_dispatch": 1, "precrop_iters": 0,
    "precrop_frac": 0.5, "num_path_samples": 8, "sparsity_weight": 0.0,
    "use_fine_sparsity": False, "use_online_sparsity": True,
    "extra_batch_size": 1024, "normal_loss_weight": 0.0,
    "normal_smooth_weight": 0.0, "anneal_delay_steps": 80000,
    "anneal_max_steps": 160000, "beta_weight": 0.0, "bg_weight": 0.0,
    "bg_smooth_weight": 0.0, "bg_patch_size": 0, "eval_once": True,
    "save_output": True, "chunk": 8192, "eval_train": False,
    "matmul_precision": "highest", "profile": False, "scan_unroll": 8,
    "march_mode": "scan", "tile_size": 16, "tile_stride": 1,
    "tile_images": False, "march_window": 16, "march_refetch": 8,
    "march_interp": "highest", "march_interp_all": "inherit",
    "march_emit": "full", "march_skip": "off", "march_bwd_dtype": "float32",
    "march_bwd_impl": "auto", "mlp_dtype": "float32", "mlp_kernel": "xla",
    "mlp_remat": False, "march_oow_action": "fallback",
}

IGNORED_FLAGS = {
    # The CUDA marches (K1-K3) gather from the whole grid in device memory:
    # there is no VMEM window to size, refetch, calibrate or police, and no
    # choice between the scan, tiled and fused marchers to make.
    "march_mode": "one CUDA march per stage",
    "march_emit": ("the consumer decides: radiance emits lean (K1) unless "
                   "online sparsity reads the dense grad n (K2 with the "
                   "head off), 'all' the full path"),
    "march_window": "no grid window",
    "march_refetch": "no grid window",
    "march_oow_action": "no grid window, so nothing is ever clamped",
    "march_skip": "no free-space skip",
    "scan_unroll": "no lax.scan",
    # The march interpolates in fp32 (ROADMAP.md Queue 3: the interp and
    # reverse-sweep precision knobs stay off until measured on the card).
    "march_interp": "fp32 interpolation",
    "march_interp_all": "fp32 interpolation",
    "march_bwd_dtype": "K3 runs in fp32; the bf16 sweep is not honoured",
    "march_bwd_impl": "K3 is the one reverse sweep",
    "matmul_precision": "fp32 products with TF32 off",
    # Rematerialisation of the MLPs under jax.checkpoint: autograd keeps
    # the nn.Linear activations, and K5 recomputes its own.
    "mlp_remat": "autograd keeps the activations; K5 recomputes its own",
}
# The radiance MLPs' implementations (models/nerf.py): nn.Linear, or the
# fused K4/K5 with features given or encoded in the kernel.
MLP_KERNELS = ("xla", "pallas", "pallas_pe")
# tile_size sizes the TPU march blocks too; the port reads it only for
# `batching: tile` and renders in fixed 16x16 pixel tiles (utils/render.py).


@dataclasses.dataclass
class Config:
  """gin-configurable global config."""
  kernel_size: int = 3
  kernel_sigma: float = 1.0
  voxel_grid: str = "voxelize"
  radiance_weight_name: str = "radiance"
  ior_weight_name: str = "ior"
  all_weight_name: str = "all"

  @classmethod
  def from_gin(cls, bindings):
    kwargs = {}
    for f in dataclasses.fields(cls):
      key = f"Config.{f.name}"
      if key in bindings:
        kwargs[f.name] = bindings[key]
    return cls(**kwargs)


def _strip_comment(line):
  """Drop a '#' comment that is outside quotes."""
  out, quote = [], None
  for ch in line:
    if quote:
      if ch == quote:
        quote = None
    elif ch in "'\"":
      quote = ch
    elif ch == "#":
      break
    out.append(ch)
  return "".join(out).strip()


def yaml_scalar(text):
  if text in ("true", "True", "TRUE"):
    return True
  if text in ("false", "False", "FALSE"):
    return False
  if text in ("", "~", "null", "Null", "NULL"):
    return None
  if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
    return text[1:-1]
  for cast in (int, float):
    try:
      return cast(text)
    except ValueError:
      pass
  return text


def read_flat_yaml(pth):
  """{key: scalar} from a YAML file of flat `key: value` lines."""
  out = {}
  with open(pth) as f:
    for lineno, line in enumerate(f, 1):
      body = _strip_comment(line)
      if not body:
        continue
      key, sep, value = body.partition(":")
      if not sep or not key.strip() or line[:1].isspace():
        raise ValueError(f"{pth}:{lineno}: not a flat `key: value` line")
      out[key.strip()] = yaml_scalar(value.strip())
  return out


def parse_gin_line(line):
  """One `Class.param = literal` binding -> (key, value), or None."""
  body = _strip_comment(line)
  if not body:
    return None
  key, sep, value = body.partition("=")
  key = key.strip()
  if not sep or "." not in key:
    raise ValueError(f"malformed gin binding: {line!r}")
  try:
    return key, ast.literal_eval(value.strip())
  except (ValueError, SyntaxError) as e:
    raise ValueError(f"cannot parse gin value in {line!r}") from e


def parse_gin(files, bindings=None):
  """Gin files + override strings -> flat {key: value}."""
  out = {}
  for fname in files or []:
    with open(fname) as f:
      for line in f:
        kv = parse_gin_line(line)
        if kv is not None:
          out[kv[0]] = kv[1]
  for binding in bindings or []:
    kv = parse_gin_line(binding)
    if kv is not None:
      out[kv[0]] = kv[1]
  return out


def parse_flag_overrides(items):
  """['--name=value', '--flag', '--noflag'] -> {name: value}, as absl
  parses a command line's flags; every name must be a known flag."""
  out = {}
  for item in items:
    if not item.startswith("--"):
      raise ValueError(f"unexpected argument {item!r}")
    name, sep, value = item[2:].partition("=")
    if sep:
      out[name] = yaml_scalar(value)
    elif name.startswith("no") and name[2:] in FLAG_DEFAULTS:
      out[name[2:]] = False
    else:
      out[name] = True
  unknown = sorted(set(out) - set(FLAG_DEFAULTS))
  if unknown:
    raise ValueError(f"unknown flags {unknown}")
  return out


def load_args(config=None, gin_files=None, gin_params=None, **overrides):
  """Flag namespace, gin Config and bindings for a run.

  Args:
    config: path of a flag overlay without its `.yaml` extension, as the
      JAX package's --config takes it; None keeps the flag defaults.
    gin_files, gin_params: gin files and binding strings.
    overrides: explicit flag values; they win over the overlay.

  Returns:
    (args SimpleNamespace, Config, bindings dict).
  """
  values = dict(FLAG_DEFAULTS)
  if config is not None:
    pth = config + ".yaml"
    overlay = read_flat_yaml(pth)
    unknown = sorted(set(overlay) - set(FLAG_DEFAULTS))
    if unknown:
      raise ValueError(f"Invalid args {unknown} in {pth}.")
    values.update(overlay)
  unknown = sorted(set(overrides) - set(FLAG_DEFAULTS))
  if unknown:
    raise ValueError(f"unknown flags {unknown}")
  values.update(overrides)
  if values["mlp_kernel"] not in MLP_KERNELS:
    raise ValueError(f"mlp_kernel must be one of {MLP_KERNELS}, got "
                     f"{values['mlp_kernel']!r}")
  values["config"] = config
  values["gin_file"] = list(gin_files or [])
  bindings = parse_gin(gin_files, gin_params)
  return types.SimpleNamespace(**values), Config.from_gin(bindings), bindings
