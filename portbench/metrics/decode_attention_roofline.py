"""The decode-attention kernel's share of its roofline over the traced
batch: for each launch the larger of its bytes over the HBM rate and its
FLOPs over the bf16 peak (``counts.decode_attention_work``: every lane's
K and V rows up to its position once, q and the output once), summed,
over the device time of the kernel's split and combine passes, found by
their symbol names. Nothing where the kernel did not run."""
from portbench import counts

SYMBOLS = ("decode_split_kernel", "decode_combine_kernel")


def read(run):
    t, cfg = run.trace, run.cfg
    if t is None or cfg.get("kv_lora_rank"):
        return None
    seconds, launches = t.kernel_seconds(*SYMBOLS)
    if not launches:
        return None
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    D = cfg.get("head_dim") or cfg["hidden_size"] // H
    peak, bw = counts.PEAKS["bf16_flops_per_s"], counts.PEAKS["hbm_bytes_per_s"]
    bound = 0.0
    for pos in t.steps:
        flops, nbytes = counts.decode_attention_work(t.lanes, H, KV, D, pos)
        bound += cfg["num_hidden_layers"] * max(nbytes / bw, flops / peak)
    return 100.0 * bound / seconds
