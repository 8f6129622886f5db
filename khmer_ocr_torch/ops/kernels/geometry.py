"""Launch geometry of kernels K1, K1b, K2 and K3, chosen on the host from the shapes.

Plain Python (no torch), so the CPU tests check these rules in any process.
The measured numbers behind the constants come from
examples/k1_routes_torch.py (K1, and K1b with --adjoint), examples/k2_registers_torch.py (K2's float
library) and chip_smoke.py's [K2] and [K3] phases on an NVIDIA H100 80GB HBM3 at 700 W (see PERF.md).
"""

from __future__ import annotations

import math

SMS = 132  # streaming multiprocessors of an H100 SXM

# --- K1, the LSTM recurrence ---------------------------------------------

CLUSTER_HIDDEN = 192  # the hidden width the cluster route is compiled for (D = 384)
CLUSTER_CTAS = 8      # CTAs per cluster, each owning H / 8 hidden units (16 measured no faster)
CLUSTER_ROWS = (1, 2, 4, 8)
# Clusters of 8 CTAs that run at once on the H100: more wait for a second
# wave. Times below: examples/k1_routes_torch.py, T = 256, NVIDIA H100 80GB
# HBM3 at 700 W; 16 rows in 2 directions took 0.923 ms at 2 rows a cluster
# (16 clusters) and 0.710 ms at 4 (8 clusters).
MAX_CLUSTERS = 8
# The batch size per direction from which the tile route measures faster
# than the cluster route, by number of directions: with 2 directions the
# cluster route won at 96 rows (2.295 against 3.665 ms) and lost at 128
# (3.378 against 2.455 ms); with 1 it won at 256 (3.347 against 3.921 ms)
# and lost at 384 (4.505 against 3.976 ms).
TILE_FROM_BATCH = {1: 384, 2: 128}


def tile_rows(batch: int) -> int:
    """Batch rows per CTA of the tile route: enough CTAs to spread over the
    SMs while small batches still run one row per CTA."""
    for rows, least in ((8, 512), (4, 256), (2, 128)):
        if batch >= least:
            return rows
    return 1


def cluster_rows(batch: int, ndir: int = 1) -> int:
    """Batch rows per cluster of a cluster route (K1's and K1b's): the fewest
    that keep every cluster in the first wave, else the most."""
    for rows in CLUSTER_ROWS:
        if ndir * math.ceil(batch / rows) <= MAX_CLUSTERS:
            return rows
    return CLUSTER_ROWS[-1]


def k1_route(batch: int, hidden: int, ndir: int = 1) -> tuple[int, int]:
    """(route, rows) for ``batch`` rows in each of ``ndir`` directions.
    Route 0 is the tile route (one CTA per ``rows`` batch rows); any other
    route is the cluster route with that many CTAs per cluster of ``rows``
    batch rows: for hidden width 192 below the crossover, with the fewest
    rows per cluster that keep every cluster in the first wave."""
    if hidden != CLUSTER_HIDDEN or batch >= TILE_FROM_BATCH[min(ndir, 2)]:
        return 0, tile_rows(batch)
    return CLUSTER_CTAS, cluster_rows(batch, ndir)


def k1b_rows(batch: int, ndir: int = 1) -> int:
    """Batch rows per CTA of K1b's tile route (csrc/lstm_backward.cu, one
    CTA per tile and direction): the fewest that keep every CTA on its own
    SM. A step's time is one SM's pass over W_hh from L2 whatever the rows,
    so more rows help only once the CTAs outnumber the SMs."""
    for rows in CLUSTER_ROWS:
        if ndir * math.ceil(batch / rows) <= SMS:
            return rows
    return CLUSTER_ROWS[-1]


def k1b_route(batch: int, hidden: int, ndir: int = 1) -> tuple[int, int]:
    """(route, rows) of K1b, as ``k1_route`` for K1: the cluster route (8
    CTAs a cluster, W_hh in registers) with ``cluster_rows`` rows a cluster
    for hidden width 192, which it is compiled for; else the tile route with
    ``k1b_rows`` rows a CTA. Unlike K1's, K1b's cluster route has no batch
    crossover: it measured faster than the tile route, or level with it, at
    every batch swept (examples/k1_routes_torch.py --adjoint, T = 256,
    NVIDIA H100 80GB HBM3 at 700 W; 2 directions: 32 rows 0.749 against
    2.024 ms, 512 rows 6.394 against 6.761, 1024 rows 12.556 against 12.681,
    2048 rows 24.580 against 25.058; 1 direction: 2048 rows 12.581 against
    12.689). From about 1000 rows in all both routes grow by waves of about
    the same cost."""
    if hidden != CLUSTER_HIDDEN:
        return 0, k1b_rows(batch, ndir)
    return CLUSTER_CTAS, cluster_rows(batch, ndir)


def cluster_slices(hidden: int, ctas: int) -> list[list[int]]:
    """The gate columns of W_hh (H, 4H) that each CTA of a cluster owns: its
    hidden units u in [c H/C, (c+1) H/C) and their columns u, H+u, 2H+u,
    3H+u, in the kernel's unit-major order."""
    units = hidden // ctas
    return [[gate * hidden + c * units + u for u in range(units) for gate in range(4)] for c in range(ctas)]


# --- K2, the decoder layer step ------------------------------------------

MAX_GROUP = 8     # lanes per cluster (the kernel's instantiations)
MAX_CLUSTER = 16  # CTAs per cluster the H100 allows (above 8 as a non-portable size)
SPLIT_FROM_TM = 1024


def k2_geometry(n_img: int, lanes: int, num_heads: int, tm: int) -> tuple[int, int, int]:
    """(lanes per cluster, clusters, CTAs per cluster) of one launch: all of
    an image's lanes in one cluster up to 8, else the largest divisor of
    ``lanes`` that is at most 8; one CTA per attention head, two when
    ``k2_split`` says so. A cluster reads slots < pos of any lane of its
    image (written by earlier launches) and slot pos of its own lanes only,
    so the clusters of one image need no synchronisation."""
    group = min(lanes, MAX_GROUP)
    while lanes % group:
        group -= 1
    clusters = n_img * (lanes // group)
    return group, clusters, num_heads * k2_split(clusters, num_heads, tm)


def k2_split(clusters: int, num_heads: int, tm: int) -> int:
    """CTAs per head: 2 (each takes half the head's columns of every
    projection and half its memory positions) for memories of 1024
    positions or more while the launch still fits the SMs at one CTA each,
    else 1. The second CTA costs three more cluster barriers and pays from
    long memories on (chip_smoke.py [K2], 3 lanes, device ms with 2 and 1
    CTAs a head: Tm=4096 one image 0.0901 and 0.1162, 8 images 0.1292 and
    0.1672; Tm=1024 one image 0.0545 and 0.0568, 8 images 0.0637 and
    0.0739; Tm=256 one image 0.0466 and 0.0464, 8 images 0.0560 and 0.0495)."""
    fits = 2 * num_heads <= MAX_CLUSTER and clusters * 2 * num_heads <= SMS
    return 2 if fits and tm >= SPLIT_FROM_TM else 1


# The SMs whose clusters a launch can hold at one CTA an SM: the H100 holds
# 30, 15 and 7 clusters of 4, 8 and 16 such CTAs at once
# (cudaOccupancyMaxActiveClusters, examples/k2_registers_torch.py).
ONE_CTA_CLUSTER_SMS = 120


def k2_two_ctas_an_sm(clusters: int, ctas_per_cluster: int) -> bool:
    """Whether a float32 K2 launch takes the library bounded for two CTAs an
    SM (80 registers, spills) rather than one (168, none): only when its
    clusters outnumber those one CTA an SM holds at once, so that the
    launch runs in one wave instead of two or more. One CTA an SM measured
    faster while every cluster fits (8 x 3, Tm 256: 0.0471 against 0.0496
    ms), two beyond (64 x 3: 0.2067 against 0.2712 ms; 8 x 3 at Tm 4096, 16
    CTAs a cluster: 0.1318 against 0.1648), NVIDIA H100 80GB HBM3, 700 W."""
    return clusters > ONE_CTA_CLUSTER_SMS // ctas_per_cluster


# --- K2's card route (csrc/decoder_layer_card.cu) -------------------------

CARD_NC_MAX = 12    # output columns a projection CTA owns at most
CARD_WS_MAX = 6144  # floats of a projection CTA's weight slice
CARD_KC = 384       # input columns a projection CTA stages at once (a LayerNorm's whole row)
CARD_MAX_ROWS = 32  # greedy rows (one an image) up to which the card route runs, all staged at once
CARD_MAX_TM = 1024  # memory positions up to which it runs


def k2_card_split(n: int, k: int) -> tuple[int, int]:
    """(columns a CTA owns, parts of the inputs) of the card route's
    projection of ``k`` inputs to ``n`` outputs: the inputs split into
    parts of ``CARD_KC`` (one part up to it; each part's CTAs write partial
    sums that the last phase adds in order), then the fewest columns, a
    multiple of 4 dividing ``n``, that keep the launch's (n / nc) x parts
    CTAs within the card's SMs, with a CTA's slice of the weight (k / parts
    x nc floats) within ``CARD_WS_MAX``; (0, parts) if none does. At D = 384,
    F = 1536: 12 columns for q|k|v (96 CTAs) and the FFN's first weight
    (128), 4 for the out-projections and the cross q (96), and 12 columns in
    4 parts for the FFN's second weight (128)."""
    parts = max(1, -(-k // CARD_KC))
    if k % parts or (k // parts) % 4:
        return 0, parts
    for nc in range(4, CARD_NC_MAX + 1, 4):
        if n % nc == 0 and n // nc * parts <= SMS and k // parts * nc <= CARD_WS_MAX:
            return nc, parts
    return 0, parts


def k2_card_fits(d: int, heads: int, f: int) -> bool:
    """Whether the card route's kernels take these widths: the LayerNorm's
    row within one staged chunk, every projection with its columns, heads
    of 32, 48 or 64 columns (the attention kernels' instantiations)."""
    if heads < 1 or d % heads or d > CARD_KC or d % 4 or f % 4 or d // heads not in (32, 48, 64):
        return False
    return all(k2_card_split(n, k)[0] for n, k in ((3 * d, d), (d, d), (f, d), (d, f)))


def k2_route(n_img: int, lanes: int, tm: int, itemsize: int, head: bool, d: int, heads: int, f: int) -> str:
    """K2's route for one launch: "card" (csrc/decoder_layer_card.cu: each
    weight byte read by one CTA for every row of the batch, seven launches
    over the whole card) or "cluster" (csrc/decoder_layer_step.cu: one
    cluster of a CTA a head for each image and group of lanes).

    The card route takes greedy batches (one lane, no lineage) in float32
    storage without the fused head, at widths it fits (``k2_card_fits``), up
    to ``CARD_MAX_ROWS`` rows and ``CARD_MAX_TM`` memory positions, where
    the cluster route's clusters need more SMs than two CTAs an SM hold at
    once (a second wave). The crossover (chip_smoke.py [K2], NVIDIA H100
    80GB HBM3, 700 W, device ms of a replayed launch, card route / cluster
    route): greedy 32 x 1 at w 160, Tm 384 0.0718 / 0.1213 and 31 x 1 at w
    64 0.0730 / 0.1042, but 28 x 1 0.0766 / 0.0656 and 24 x 1 0.0716 /
    0.0610. Each of the card route's launches costs a chain of dependent
    latencies, about 4-6 us, whatever the batch, so it pays only where the
    cluster route runs in two waves. Beam batches keep the cluster route:
    a card route over (image, lane group, head) attention CTAs took 8 x 3 at
    Tm 256 in 0.0577 ms against 0.0472 and 1 x 3 in 0.0458 against 0.0442. bfloat16
    storage and the fused head keep the cluster route, which is templated on
    the storage type and fuses the head (its times: PERF.md's kernel
    table)."""
    if itemsize != 4 or head or lanes != 1 or not k2_card_fits(d, heads, f):
        return "cluster"
    if n_img > CARD_MAX_ROWS or tm > CARD_MAX_TM:
        return "cluster"
    _, clusters, ctas = k2_geometry(n_img, lanes, heads, tm)
    return "card" if clusters * ctas > 2 * ONE_CTA_CLUSTER_SMS else "cluster"


# --- shared memory of the cluster layer (csrc/decoder_cluster.cuh) ---------

NT = 384               # threads per CTA (csrc/decoder_common.cuh)
SMEM_LIMIT = 232448    # bytes of shared memory one H100 CTA may use
K2_TC = 512            # K2's attention positions per chunk


def layer_smem_floats(group: int, d: int, heads: int, f: int, split: int, tc: int, vw: int = 4) -> int:
    """Floats of one CTA's shared memory for the cluster layer
    (decoder_cluster.cuh::smem_floats): x, qkv, a, t, hid, part, y, the
    chunk's weights and rows, the S > 1 merge slots, the split-k sums and the
    softmax statistics. ``vw``: the elements of a 16-byte vector of the
    storage type (4 in float32, 8 in bfloat16), the columns a thread carries,
    which sizes the split-k sums."""
    hd = d // heads
    red = group * max(vw * NT, d, 3 * hd, f // heads)
    xo = split * (group * hd + 4 * group) if split > 1 else 0
    return (4 * group * d + 3 * group * hd + group * (f // (heads * split)) + heads * group * hd + 2 * group * tc
            + xo + red + 4 * group)


# --- K3, the whole beam decode ---------------------------------------------


def k3_tc(tm: int, max_len: int) -> int:
    """K3's attention chunk: every memory position and every cache slot in
    one chunk, rounded up to a warp's 32 positions."""
    return 32 * math.ceil(max(tm, max_len, 1) / 32)


def k3_vocab_cols(vocab: int, num_heads: int, vw: int = 4) -> int:
    """The head's padded width Vp: a multiple of ``vw`` x heads, so that each
    CTA computes Vp / heads columns in 16-byte vectors (``vw`` elements: 4
    in float32, 8 in bfloat16; 128 for vocab 124 and 8 heads either way)."""
    return vw * num_heads * math.ceil(vocab / (vw * num_heads))


def k3_smem_bytes(k: int, d: int, heads: int, f: int, max_len: int, vocab_cols: int, n_layers: int,
                  on_chip: bool, tc: int, itemsize: int = 4) -> int:
    """Bytes of one K3 CTA's shared memory (decode_loop.cu::smem_bytes): the
    cluster layer's, the head's self-cache slice of every layer when on
    chip (``itemsize`` bytes an element, the storage type's, rounded up to
    16 bytes), and the search state."""
    cache = 16 * math.ceil(n_layers * 2 * k * max_len * (d // heads) * itemsize / 16) if on_chip else 0
    lp = max_len + 2
    state = 2 * k * lp + 2 * k * max_len + lp + k * vocab_cols + 2 * k * k + 3 * k + 1
    return 4 * (layer_smem_floats(k, d, heads, f, 1, tc, 16 // itemsize) + state) + cache


def k3_geometry(k: int, d: int, heads: int, f: int, max_len: int, vocab: int, n_layers: int,
                tm: int, itemsize: int = 4) -> tuple[int, bool, int]:
    """(CTAs per cluster, self caches on chip, attention chunk) of one K3
    launch: one cluster of one CTA per head for each image; CTA h keeps head
    h's slice of every layer's self caches in shared memory when the whole
    CTA fits the H100's 232,448 bytes (K <= 3 at the flagship in float32,
    K <= 4 in bfloat16, whose caches take half the bytes), else in a
    head-major global scratch. A CTA takes an SM's registers on either route,
    so both hold the same clusters at once (15 at the flagship on an H100)
    and the on-chip route is never the slower one."""
    tc = k3_tc(tm, max_len)
    vp = k3_vocab_cols(vocab, heads, 16 // itemsize)
    on_chip = k3_smem_bytes(k, d, heads, f, max_len, vp, n_layers, True, tc, itemsize) <= SMEM_LIMIT
    return heads, on_chip, tc
