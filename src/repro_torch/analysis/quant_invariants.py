"""quant-invariants checker: the port's format registry and pack geometry
(counterpart of ``repro/analysis/quant_invariants.py``).

The paper's compression and the format registry (``core/quant.py``) rest
on arithmetic nothing in the type system states: ``bits * pack`` fills
``pack_storage`` storage elements exactly (int4: 4 x 2 = 8 x 1, int3:
3 x 8 = 8 x 3); ``qmax`` is the symmetric range of ``bits`` for an integer
grid, and the storage type's largest finite value for a float grid (fp8:
448); a packed format ships its unpack hook (``dequantize`` and the
embedding gather read logical values through it); and every format's
kernel hook names an entry of ``kernels/ops.py``'s ``KERNEL_HOOKS``. The
port's ``QuantFormat`` has no ``kind`` field: a floating storage type is
the float grid.

Straddle check, on shapes alone: for every arch config, every quantizable
dim (d_model, q/kv projections, d_ff, vocab_padded, expert and MLA dims,
the SSM's inner width) and every tensor-parallel degree in ``TP_DEGREES``,
a shard's contraction length must be a whole number of storage elements
of every packed format, and the group size ``largest_pow2_group`` picks
for it a multiple of ``pack``. ``TP_DEGREES`` reaches 16, the model axis
of the production meshes (``launch/mesh.py``), where the policy sizes
groups to n/tp (``core/policy.leaf_group_size``); the card runs 1 x 1, so
this is arithmetic on the configs: a shard split it flags is one the
placement (``dist/sharding.validate_quant_partition``) would refuse.

A project checker: it imports the live registries (quant formats, kernel
hooks, arch configs); tests inject synthetic ones through the constructor.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from repro_torch.analysis.engine import BaseChecker, Finding

TP_DEGREES = (1, 2, 4, 8, 16)
REGISTRY_ANCHOR = "src/repro_torch/core/quant.py"
CONFIG_ANCHOR = "src/repro_torch/configs"


def _config_dims(cfg) -> dict[str, int]:
    """Named quantizable contraction/output dims of one arch config."""
    dims = {
        "d_model": cfg.d_model,
        "q_dim": cfg.q_dim,
        "kv_dim": cfg.kv_dim,
        "d_ff": cfg.d_ff,
        "vocab_padded": cfg.vocab_padded,
    }
    if cfg.moe:
        dims["moe.d_expert"] = cfg.moe.d_expert
    if cfg.mla:
        dims["mla.kv_lora_rank"] = cfg.mla.kv_lora_rank
        if cfg.mla.q_lora_rank:
            dims["mla.q_lora_rank"] = cfg.mla.q_lora_rank
    if cfg.ssm:
        dims["ssm.d_inner"] = cfg.ssm.expand * cfg.d_model
    return dims


class QuantInvariantsChecker(BaseChecker):
    id = "quant-invariants"
    description = ("QuantFormat entries internally consistent; no tp shard "
                   "boundary can straddle a pack group on any arch config")

    def __init__(self, formats=None, configs=None, kernel_hooks=None,
                 tp_degrees: Sequence[int] = TP_DEGREES):
        """``formats``: {name: QuantFormat}-like mapping; ``configs``:
        iterable of ModelConfig; ``kernel_hooks``: valid kernel hook names.
        None loads the port's live registries."""
        self._formats = formats
        self._configs = configs
        self._kernel_hooks = kernel_hooks
        self.tp_degrees = tuple(tp_degrees)

    def _load(self):
        if self._formats is None:
            from repro_torch.core import quant
            self._formats = dict(quant._FORMATS)
        if self._kernel_hooks is None:
            from repro_torch.kernels.ops import KERNEL_HOOKS
            self._kernel_hooks = set(KERNEL_HOOKS)
        if self._configs is None:
            from repro_torch.models.registry import ARCH_IDS, load_config
            self._configs = [load_config(a) for a in ARCH_IDS]

    def check_project(self, root: str) -> Iterable[Finding]:
        self._load()
        yield from self._check_formats()
        yield from self._check_straddle()

    # -- per-format internal consistency ------------------------------------
    def _check_formats(self) -> Iterable[Finding]:
        import torch

        def err(msg):
            return Finding(self.id, REGISTRY_ANCHOR, 1, msg)

        for name, fmt in sorted(self._formats.items()):
            tag = f"format {name!r}:"
            dt = fmt.storage_dtype
            storage_bits = 8 * dt.itemsize
            if fmt.pack < 1 or fmt.pack & (fmt.pack - 1):
                yield err(f"{tag} pack factor {fmt.pack} must be a power of "
                          "two (group sizes are powers of two; any other "
                          "pack cannot tile a group)")
                continue
            pack_storage = getattr(fmt, "pack_storage", 1)
            if fmt.bits * fmt.pack != storage_bits * pack_storage:
                yield err(f"{tag} bits({fmt.bits}) x pack({fmt.pack}) = "
                          f"{fmt.bits * fmt.pack} does not fill "
                          f"pack_storage({pack_storage}) x {storage_bits}-bit "
                          "storage elements — packed bytes would carry dead "
                          "or truncated bits")
            if dt.is_floating_point:
                top = torch.finfo(dt).max
                if fmt.qmax != int(top):
                    yield err(f"{tag} qmax {fmt.qmax} != {top:g}, the largest finite "
                              f"value of its {dt} float grid")
            elif fmt.qmax != 2 ** (fmt.bits - 1) - 1:
                yield err(f"{tag} qmax {fmt.qmax} != 2^{fmt.bits - 1}-1 = "
                          f"{2 ** (fmt.bits - 1) - 1} — the symmetric range "
                          "of Eq. 1 for this bit width")
            if fmt.pack > 1 and fmt.unpack_fn is None:
                yield err(f"{tag} pack > 1 requires unpack_fn (dequantize and the "
                          "embedding gather read logical values through it)")
            if fmt.kernel not in self._kernel_hooks:
                yield err(f"{tag} kernel hook {fmt.kernel!r} not in "
                          f"kernels/ops.py KERNEL_HOOKS "
                          f"{sorted(self._kernel_hooks)} — the quantized linear "
                          "would have no kernel for this format")

    # -- pack-group vs shard geometry ---------------------------------------
    def _check_straddle(self) -> Iterable[Finding]:
        from repro_torch.core.quant import largest_pow2_group

        packed = [(n, f) for n, f in sorted(self._formats.items()) if f.pack > 1]
        if not packed:
            return
        for cfg in self._configs:
            gs_pref = cfg.group_size
            if gs_pref & (gs_pref - 1):
                yield Finding(
                    self.id, CONFIG_ANCHOR, 1,
                    f"{cfg.arch_id}: group_size {gs_pref} is not a power of "
                    "two — the per-leaf GS descent assumes pow2")
                continue
            for dim_name, n in _config_dims(cfg).items():
                for tp in self.tp_degrees:
                    if n % tp:
                        continue  # this (dim, tp) is not shardable
                    shard = n // tp
                    gs = largest_pow2_group(shard, gs_pref, min_gs=16)
                    if gs is None:
                        # no pow2 group >= 16 divides the shard: the policy
                        # leaves such a leaf in float, nothing packed to straddle
                        continue
                    for fname, fmt in packed:
                        if shard % fmt.pack:
                            yield Finding(
                                self.id, CONFIG_ANCHOR, 1,
                                f"{cfg.arch_id}: {dim_name}={n} at tp={tp} "
                                f"gives shard {shard}, not a multiple of "
                                f"{fname}'s pack {fmt.pack} — a storage "
                                "element would straddle the shard boundary")
                        elif gs % fmt.pack:
                            yield Finding(
                                self.id, CONFIG_ANCHOR, 1,
                                f"{cfg.arch_id}: {dim_name}={n} at tp={tp} "
                                f"picks GS={gs}, not a multiple of "
                                f"{fname}'s pack {fmt.pack} — a pack group "
                                "would straddle a quantization group")
