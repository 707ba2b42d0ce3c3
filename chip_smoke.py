#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gigl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs CUDA

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from gigl_tpu_torch/csrc and prints the build time;
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes of the flagship configuration (bench.py:593-615: N=100k nodes,
   E=2M edges, D=128, fanouts (15, 10), batch 512, GraphSAGE hidden 256,
   out 128, bf16; R=512 random negatives), and times both (device time from
   CUDA-graph replay, plus the wrapper's eager time; warm L2). The training
   kernels are checked on a real first training step: K1b on its random
   negatives (yardstick torch.randint: the same distribution, other bits;
   also behind K1's draw of the positives, the pair replayed from one CUDA
   graph as the step runs them, and at 65,536 ids), K5 on its [512, 1024]
   bf16 score matrix, K4b on layer 2's [512, 15, 256] bf16 block;
4. runs the port's sampled-inference path — NALPTrainer(cached_hop,
   fused_cache) -> run_inference over all nodes — with every kernel's launch
   count reset just before and read just after, checks the export, and
   recomputes batch 0 through the plain versions, and times one batch's
   device work alone (CUDA-graph replay) beside the host-clocked ms/batch;
5. recomputes one training step (loss and every gradient) through the
   plain versions only and holds the kernel path to it;
6. runs the port's training path — NALPTrainer(..., optimizer_args={
   "learning_rate": "1e-3"}) -> init_state -> 5 warm-up steps ->
   train_steps over 200 steps (anchors arange(B*K) % N, bench.py:617) —
   with the launch counts reset just before and read just after; prints
   ms/step, edges/s (counted as bench.py:631-638 counts them) and, from
   torch.profiler over 20 more steps, the device ms/step, the device-busy
   share and the five device ops that took longest;
7. exact full-graph inference: times EllGraph.from_csr of the
   flagship graph on the host; holds K6 ell_aggregate (mean, sum, max,
   GCN-weighted; the largest bucket's rows of its one launch over the
   graph) and K7 fanout_attention (GAT v1, GATv2, Transformer, H=4)
   against their plain versions at the flagship's largest ELL bucket
   ([77,433, 32]) in bf16, and K6 mean over the whole graph at the
   full-graph pass's and the ELL full-batch step's layer widths (bf16 and
   fp32, D 128 and 256; the bound of each path's K6 beside them; the pass
   checked at one K6 launch a layer) (K7 also GAT in fp32 at head dims 64
   and 4, the
   full-batch GAT step's two layers; its row and K7b's print the loads
   ahead compiled in, `kDepth`) and times them beside their bounds and
   library yardsticks; then runs run_full_graph_inference at full width for the
   flagship GraphSAGE and for GAT v1 with 4 heads (hidden 256, out 128,
   bf16, seeded init_params), each with the launch counts reset just before
   and read just after, checks the export and recomputes the whole pass
   through the plain versions; prints the host-clocked encode time, the
   profiler's device time per pass, nodes/s, edges aggregated per pass
   and the peak memory;
8. node-classification training (the graph carries 16 random labels, as
   _ell_bench.py:9-18 draws them): holds K6b ell_transpose_aggregate (mean
   at layer 2's [100k, 256] fp32 cotangent; GCN, max, weighted, GATv2)
   over the whole transpose walk and K7b fanout_attention_bwd (GAT at head
   dims 64 and 4, GATv2, Transformer) at the largest bucket against their
   plain versions, with bounds, an index_add_ yardstick (K6b) and an
   SDPA-backward one (K7b, Transformer mode); then, per model, one
   training step through the kernels against the same step through the
   plain versions on the card, and the path itself with the launch counts
   reset just before and read just after: FullBatchTrainer
   (full_batch_data_from_graph, 2 layers, hidden 256, fp32, Adam 1e-2;
   GraphSAGE and GAT with 4 heads) and NodeClassificationTrainer
   (milestone 2's GAT: 3 layers, fanouts (15, 10, 5), hidden 64, 4 heads,
   lr 0.005, batch 256, four batches of labeled nodes cycled; GraphSAGE at
   fanouts (15, 10)); prints ms/step, edges/s or seeds/s, the profiler's
   device time, busy share and top ops, peak memory, first and last loss;
9. full-batch training over the COO segment ops (the same graph, labels
   and widths): times the two SegmentIndex builds (destination and source)
   on the host; holds K8b segment_reduce_bwd (sum, mean, max with ties,
   per-head weighted) over the whole source walk at layer 2's [100k, 256]
   fp32 cotangent in its composed mode (the segment ids the source index
   was built from) and its chained mode (a copy: chained_ms), bit-equal,
   K9b segment_softmax_bwd at [2M, 4] (fp32 and bf16: modes coo_fp32 /
   coo_bf16 on its row, with gathered_bytes), K10b at [2M, 4] in the
   COO Transformer step's mode (the coefficients alone, fp32 g and bf16 g;
   yardstick torch.mul) and with the scale's cotangent (fp32, within 1e-6
   of sum |g raw| of an fp64 sum; yardstick torch.linalg.vecdot), each one
   CUDA launch by torch.profiler's count, and the whole sddmm
   backward (K10b's coefficients and the scale's cotangent, with K8 for dq
   and K8b for dk; 4 heads of 64) against autograd through the plain
   twins, with bounds and yardsticks (K8b: sparse.mm of the source-sorted
   CSR, values 1 or 1 / count, for sum and mean, and index_add_ of the
   gathered rows beside it; the torch composition of the softmax
   backward), each repeated for the same
   bits; K10 sddmm and K8 segment_reduce (weighted per head by an [E, 4]
   alpha) at the COO Transformer's two layers (the 2M edges in their random
   order, 4 heads of 64 and of 4 fp32 values) against their plain twins,
   with bounds, gathered_bytes (E x a gathered row's bytes) and yardsticks
   (sparse.sampled_addmm; sparse.mm beside K8's unweighted sum), modes
   coo_layer1 / coo_layer2 on the kernel rows, and K9 segment_softmax at
   the steps' [2M, 4] logits, fp32 and bf16 (modes coo_fp32 / coo_bf16 on
   its row; gathered_bytes: a 32-byte sector a slot read and one written;
   the softmax in PyTorch beside fp32); then per model (GraphSAGE
   mean, GAT v1 and Transformer, 4 heads)
   FullBatchTrainer(build_ell=False) — one step against the same step
   through the plain twins, then 3 + 50 steps with the launch counts reset
   just before and read just after, and 5 profiled;
10. heterogeneous inference and training (a typed graph of the DBLP
   configuration's shape, examples/configs/dblp_hetero_nalp_task_config.yaml,
   at the flagship's scale: 100k papers, 50k authors, 400k
   author-writes-paper edges and their reverse, 1M paper-cites-paper edges,
   fp32 features 128 wide, numpy seed 0): times the SegmentIndex builds on
   the host; holds K8 segment_reduce (sum, mean, max, and the per-head
   weighted sum of HGT), K9 segment_softmax and K10 sddmm against their
   plain versions at the papers' 1.4M in-edges, H*dk = 128, with bounds and
   library yardsticks; then runs run_full_graph_inference_hetero for the
   configuration's HGT (4 heads, hidden 128, out 64, 2 layers, final
   linear, fp32) and for RGCN with 2 bases at the same widths, and the
   sampled typed HGT path (HeteroNALPTrainer.encode_batch over node_batches
   of 512, every node of both types, live and tabularized, with the yaml's
   message-passing paths), each with the launch counts reset just before
   and read just after, the export checked and the pass (sampled: batch 0
   of each type) recomputed through the plain versions; prints encode ms,
   nodes/s, device ms, busy share and peak memory. Then typed NALP training
   for HGT and RGCN (the yaml's: papers anchored on author-writes-paper,
   authors as candidates, batch 512, 1 positive, 512 random negatives,
   retrieval loss at temperature 0.07, Adam 1e-3, live draws): one step
   against the same step through the plain versions, then 5 + 100 steps
   with the launch counts reset just before and read just after, 5
   profiled, and evaluate over 4 batches; prints ms/step and edges/s
   (counted over the typed tree as bench.py:631-638 counts them);
11. edge features (the flagship graph with 8 fp32 features per edge,
   ogbn-proteins' width, numpy seed 8): holds K6 in its gine mode (at the
   largest bucket and over the whole graph) and K7
   with the edge addend at the largest bucket (bf16; K7 also without the
   addend in the same call), K6b gine over the whole transpose walk, K7b
   with the addend, and K11 ell_edge_grad in its three modes at EdgeAttrGAT
   layer 1's [2M, 256] fp32 (yardstick: index_select of the flat
   cotangent by edge_pos) against their plain versions; then, each with
   the launch counts reset just before and read just after and checked
   against the plain twins on the card: run_full_graph_inference with
   edge_attr for GINE (hidden = out = 128) and for EdgeAttrGAT and the
   Transformer with lin_edge (4 heads, hidden 256, out 128, bf16);
   FullBatchTrainer over the ELL tables with FullBatchData.edge_attr
   (GINE hidden 128, EdgeAttrGAT 4 heads hidden 256; 3 + 50 steps, the
   edge rows' gradient held too); the live NALPTrainer over the
   edge-featured graph (EdgeAttrGAT, fanouts (15, 10), batch 512, 1 hard
   negative, R = 512, label-edge features on the supervision and
   hard-negative edges, EdgeFeatureScorer(32), Adam 1e-3) and
   run_inference over it; typed NALP training of HGT with label-edge
   features on the author-writes-paper edges and the scorer; and SimpleHGN
   (4 heads, hidden 128, out 64) on K7 with its relation bias:
   encode_batch and training. GATv2 with edge rows (ROADMAP B6b; 4 heads,
   hidden 256, lin_edge over the raw 8-wide rows): K7 and K7b in their
   GATv2 mode with the edge addend at the largest bucket, K11's gatv2 mode
   at [2M, 256] fp32 and K6b's sum of an [E, 256] table over
   EllGraph.t_edge (yardstick index_add_; beside it the gate-read design
   it replaced, K6b's GATv2 mode) against their plain versions;
   run_full_graph_inference with edge_attr (bf16) and the ELL
   FullBatchTrainer (fp32, the plain step replaying the kernel step's
   leaky gates), each mode's launches on its path;
12. times K7 and K7b in their GAT mode with SimpleHGN's relation bias
   alone, at the largest dense block of a SimpleHGN training step (its own
   inputs, recorded from the step), against their plain versions;
13. quantized tables and the logQ correction on the flagship NALP path:
   DeviceGraph.from_hetero(quantize_features=True) (int8 features, 4x
   smaller), then holds K12 gather_rows_q8 (the step's 512 x 15 first-hop
   rows with their degrees, and the whole table; beside K3 over the fp32
   rows; its segmented launch at a quantized inference batch's four
   gathers and a live tree's three levels, one launch each by the
   wrapper's count and by torch.profiler's, beside the same kernel
   launched once a gather), K13 cms_add and K14 cms_estimate (the 1,024
   candidate ids of a real first step, on a fresh sketch and on one that
   has counted 20 steps; yardstick scatter_add_; K13 also into a 5 x
   16384 sketch; K14 alone and the K13 -> K14 pair from one CUDA graph,
   there and at 65,536 ids over a 5 x 16384 sketch), K2
   in its int8 mode over the whole graph and K5 with the logQ term at
   [512, 1024] bf16 against their plain versions (bit-equal where
   integer or one rounding); one step of
   NALPTrainer(cached_hop=True, quantize_cache=True, use_cms_correction=
   True) against the same step through the plain versions, and the sketch
   after a step against a plain recount of its candidates; then the path
   (5 + 200 steps, 20 profiled; the refresh timed: K2 int8 and the host
   quantize) with the launch counts reset just before and read just
   after, the sketch's total checked (205 x 1024) and K12's launches (3
   a step: one an encode chain), the step's host cost
   in turns (phase 6's fp32 fused-table step, the int8 tables without the
   sketch, with it: 50 steps a turn, A B C C B A), and run_inference over
   every node of the quantized graph (one K12 launch a batch checked;
   batch 0 recomputed through the plain versions);
14. partitioned NALP training: the flagship graph range-partitioned over
   make_mesh(4), four shards sharing the one card (the collectives are
   copies within its memory: no NVLink traffic is measured), live
   sampling, capacity factor 4. In fp32, the per-shard pool's loss
   against the mean of the replicated NALPTrainer's per-shard losses (the
   same anchors and draws) and the ring pool's against K5 over the whole
   batch's [512, 1024] score matrix (1e-5 relative), and one step of each
   pool (the sketch on) against the same step through the plain versions;
   K15 route_requests (every shard's request vector in one call, and one
   vector alone: mode single) and K16 unroute_rows (bit-equal; yardsticks:
   a stable sort with scatter_add_ counts, index_select + where), K17
   ring_retrieval's fold and backward over a shard's P blocks in one
   launch each (and the fold of one block alone; yardsticks logsumexp,
   softmax; a fold and a backward a shard checked on the ring path) and
   K1's row-offset mode (against the plain mode on the same rows) at the
   shapes a real ring step gives them; then each pool's path in bf16 with
   the sketch on (3 + 20 steps, 5 profiled) with the launch counts reset
   just before and read just after, zero overflow and the sketch's total
   checked, and encode_batch over every node (batch 0 against the plain
   versions); prints ms/step, edges/s, launches and all_to_all bytes per
   step, nodes/s;
15. the ring halo exchange and graph-sharded full-batch training on the
   same graph over make_mesh(4) (25,000 rows a shard): times the ring
   schedule's host build and its device index (every bucket holds its
   edges, their counts sum to E); holds K18 ring_spmm against its plain
   version at the largest bucket, forward at D 128 and 256 and transposed
   at 256, with bounds and two yardsticks (torch.sparse.mm of the bucket's
   CSR, index_add_ of the gathered rows as the reference computes them);
   the whole ring (sum and mean) against one shard's and against coo_spmm;
   then per model (GCN, GraphSAGE: 2 layers, hidden 256, 16 classes, fp32,
   Adam 1e-2) ShardedFullBatchTrainer — one step against the same step
   through the plain versions (the loss, every gradient and the gradient
   into layer 2's input), then 3 + 50 steps with the launch counts reset
   just before the trainer is built and read just after (48 K18 launches a
   step checked) and 5 profiled; prints ms/step, edges/s, device ms, busy
   share, peak memory, val accuracy and phase 9's COO GraphSAGE ms/step
   beside it. Then run_partitioned_inference over phase 14's per-shard-pool
   trainer: every node into an in-memory exporter, each row against
   encode_batch's for the same ids, nodes/s;
16. weighted and top-k draws: the flagship graph with an [E, 8] fp32 edge
   table (ogbn-proteins' width; column 0 uniform [0, 1) weights, numpy
   seed 16) through DeviceGraph.from_hetero(sampling_weight_index=0), whose
   host row sort is timed; holds K19 sample_weighted bit-equal to its twin
   over all N nodes at fanout 15 (both methods), at the live hops' shapes,
   on a hub CSR (1,000 rows of degree 1,000, integer weights 0-3) and in
   its row-offset mode on shard 1 of phase 14's 4-way layout (yardstick:
   torch.topk of the prebuilt score matrix), and K2's weighted mode (fp32,
   int8, and top_k) beside its uniform mode; then, each with the launch
   counts reset just before and read just after — every path launches
   K19 and K1 only for the positives, which the reference draws uniformly
   too — the tabularized weighted NALP path (a step against the plain
   step, 5 + 50 steps, 5 profiled, run_inference over every node), the
   same refresh and run_inference with top_k, the live weighted step (6
   K19 a step), the typed DBLP-shaped encode_batch with every op weighted
   (batch 0 against the plain versions) and PartitionedNALPTrainer over
   make_mesh(4) (a fp32 step against the plain step, 3 + 10 steps, zero
   overflow); prints ms/step beside phase 6's uniform ms/step;
17. the COO per-edge terms over phase 11's edge-featured graph (the same
   flagship graph, 8 fp32 features per edge, numpy seed 8): times
   full_batch_data_from_graph(build_ell=False) and the walk-ordered
   relabelling (coo_walk) on the host; holds each new kernel mode against
   its plain twin on the card, bit-equal on a repeat run, with its bound
   and a library yardstick where one call computes the same function: K8
   gine at [2M, 128] (index_add_ of the gated rows), K8 add at EdgeAttrGAT
   layer 1's [2M, 4 x 64] fp32 weighted per head (index_add_ of the
   weighted rows), K8b gine (index_add_ of the gated cotangent rows), K10
   with the key addend and in its GATv2 mode at [2M, 4 x 64], K8b's GATv2
   source walk and K8's GATv2 destination walk (d att within 1e-6 of sum
   |terms| of an fp64 sum), K11's COO form in its three modes at [2M, 256]
   fp32 (index_select of the cotangent by dst); times K8 add over the edge
   rows in walk order, in the graph's own order and as K3-gathered blocks
   (all bit-equal); then per model (GINE hidden 128, EdgeAttrGAT and the
   Transformer with lin_edge at 4 heads and hidden 256, GATv2 at 4 heads
   and hidden 256, without and with edge rows; fp32, 2 layers, Adam 1e-2;
   GATv2 with edge rows adds K10's gatv2 mode with the edge row, K8's
   destination walk with it, K11's COO gatv2 mode and K8b's sum of a
   per-edge table along the source walk, each against its twin at
   [2M, 4 x 64] fp32, K8b beside the value and gate walks it replaced)
   FullBatchTrainer(
   build_ell=False) — one step against the same step through the plain
   twins (the raw edge table's gradient held too, rows moved by a gate on
   the two sides of 0 accounted for), then 3 + 20 steps with the launch
   counts reset just before and read just after (each new mode launched),
   5 profiled, and encode_coo against encode_ell with the trained weights
   (1e-4 of the scale); prints ms/step, edges/s, device ms, busy share, top
   ops and peak memory;
18. the partitioned tier's int8 rows, tabularized layout and
   node-classification trainer on the flagship graph over make_mesh(4)
   (capacity factor 4): times PartitionedGraph.build with fp32 [25k, 129]
   and bit-packed int8 [25k, 136] rows and with_tabularized over each
   (the cache fused in: [25k, 257] fp32, [25k, 268] int8; the frozen
   [25k, 15] tables) and prints the bytes a shard; holds the sharded
   tables bit-equal to the replicated builder's and the caches to its K2
   cache (fp32 within 1e-5 of the scale; int8, against K2's int8 mode over
   the same int8 features, within half a quantization step); one cached NALP step (fp32 and int8 rows) and one NC step (live
   over fp32 rows, cached over int8 rows) against the same steps through
   the plain versions, the int8 step's union gather decoded by K16's int8
   mode once a shard and no int8 row routed through K16's copy form; K16's
   int8 mode at that step's union lookup and at the live step's [4,
   63,744] union shape, and K12's packed-row mode over the P = 1 layout,
   bit-equal to their twins, with bounds, K16's 4-byte form over the same
   bytes and K3 over the same packed rows, and K3's byte mode over 21-byte
   rows (yardstick index_select); then the cached NALP paths (bf16, the
   sketch on; fp32 and int8 rows) and the NC paths (GraphSAGE hidden 256,
   16 classes, bf16; live over fp32, cached over int8 rows), 3 + 20 steps
   and 5 profiled each, with the launch counts reset just before the
   trainer (its tables) is built and read just after (launches a step
   counted past the build; one K16 int8 decode a shard a step checked),
   zero overflow, refresh_cache ms; run_partitioned_inference through the
   cached NC trainer over every node (batch 0 against the plain versions);
   and the one-shard int8 cached path (one K12 packed-row gather a step, no
   routing); prints ms/step, device ms, busy share, launches and
   all_to_all bytes a step, edges/s or seeds/s, nodes/s;
19. the partitioned tier's label edges and typed trainer over
   make_mesh(4) (capacity factor 4). (a) The flagship graph with EDGE_DE
   fp32 features on its E supervision edges and on 500k hard-negative
   edges (numpy seed 8), PartitionedGraph.build timed; the routed
   positives, hard negatives and their edge rows at steps 0 and 15
   bit-equal to the replicated DeviceGraph's batch (zero at padded
   slots); the flagship GraphSAGE with an EdgeFeatureScorer(8, 32), one
   hard negative: one fp32 step of each pool (per shard, ring) against the
   plain step (the scorer's gradients held too); K16 over the ring step's
   [4, C, 1, 8] edge rows (bit-equal; yardstick index_select + where) and
   K17's own-block bias mode (fold and backward with d e_pos and d e_hard,
   against the twins; timed beside the dense add + K17's plain mode, the
   plain mode alone over the biased scores, and torch.logsumexp over the
   biased masked scores) as modes on their rows;
   then each pool's path in bf16 (3 + 10 steps with the launch counts
   reset just before and read just after, zero overflow, a bias-mode fold
   and backward a shard a step on the ring; 3 profiled). (b) The typed
   partitioned trainer (PartitionedHeteroNALPTrainer) over phase 10's
   typed graph (papers anchored on author-writes-paper, authors as
   candidates, 1 positive, R = 512): HGT live, HGT tabularized
   (with_sample_tables) and RGCN with the ring pool and 8 label-edge
   features a supervision edge with the scorer (fp32): the routed trees of
   both node types bit-equal to the replicated draws, one step against the
   plain step, 3 + 10 steps with a kernel list of their own checked, 3
   profiled; then run_partitioned_inference(node_type=) through the
   tabularized HGT trainer for both types into an in-memory exporter,
   each row against encode_batch's; prints ms/step, device ms, busy share,
   all_to_all bytes a step, edges/s, nodes/s;
20. out-of-core training (ROADMAP A14): the flagship graph's features
   written to an np.memmap on local disk (build/streaming/), a
   HostGraphStore over it (the host engine built with g++, the store's
   build timed); its frozen sample table bit-equal to the device-resident
   tabularized NALPTrainer's and its hop-cache aggregate against K2's;
   three fp32 streamed steps against the device-resident trainer's from
   the same weights (1e-4 relative); then the flagship GraphSAGE (bf16,
   hidden 256, out 128, cached hop, B 512, P 1, R 512) through
   StreamingNALPTrainer.run_steps (a ring of 3 pinned slots, the copies on
   a side stream) with fp32 and bf16 streams in turns (A B B A, 5 + 50
   steps each), launches reset just before and read just after (K4, K4b
   and K5 launched; no draw and no row gather on the card), 5 profiled;
   prints host ms/step, the engine's fill ms, the streamed bytes a step,
   the copy's ms (CUDA events on the copy stream) and GB/s, device ms,
   busy share and the profiler's copy ms a step;
21. the streamed-partitioned tier (ROADMAP A17): the flagship graph's
   HostGraphStore (features in RAM) and its fused [feat | deg | agg] rows
   in a ShardedHostStore over PART_SHARDS shards (both builds timed);
   StreamingPartitionedNALPTrainer's frozen tables, step-0 draws and plan
   recv ids bit-equal to the device-resident PartitionedNALPTrainer(
   cached_hop=True)'s (its union routed at the streamed capacity), three
   fp32 steps of both schedules (sequential and pipelined, bit-equal)
   against it from the same weights (1e-5 relative); then the flagship
   GraphSAGE (bf16, hidden 256, out 128, cached hop, B 512, R 512, capacity
   factor 4) through run_steps, pipelined and sequential, with fp32 and
   bf16 answers in turns (A B B A, each turn both schedules, 5 + 30 steps
   each, the schedules' losses bit-equal; the first run's first two steps
   under set_sync_debug_mode("warn"), the implicit syncs printed),
   launches reset just before and read just after (K15, K16, K3 on the
   tables, K4, K4b and K5 launched; every K3 gather an int32 table: no
   feature row gathered on the card), 5 more profiled; prints host ms/step,
   device ms/step, busy share, the host gather's ms, the answer bytes and
   the copy's ms (CUDA events on the copy stream) and GB/s, the
   all_to_all bytes, the answer slot's padding share and edges/s. Then
   the typed trainer over phase 10's typed graph with host-resident
   features (HGT live and tabularized, RGCN with the ring pool) and the
   NC trainer (labels routed in the plan), each one step against its
   device-resident trainer (1e-5 relative) and 3 + 10 timed steps, 3
   more profiled; K16 over shard 0's streamed answers (1,028- and 514-byte
   rows: 4- and 2-byte words) against its twin, timed as a mode on its
   row;
22. the encoder and decoder options (ROADMAP A5) at the flagship's width:
   (a) the cached NALP step (cached_hop, fused_cache) with jk_mode="cat",
   linear_layer and the hadamard_mlp decoder (hidden 128), (b) the live
   step with two DCN cross layers, jk_mode="lstm" and the mlp decoder
   (its all_pairs a [512, 1024, 256] concat): each step 1 (loss and every
   gradient, the decoder's too) in fp32 against the plain twins on the card
   (the MLP's last bias, which the retrieval softmax takes out, and
   JK-lstm's att bias, which the softmax over layers takes out, held as
   zero by symmetry), then the bf16 path with the launch counts reset just
   before the trainer is built (K2's tables counted) and read after 3 + 20
   (a) or 3 + 10 (b) steps, 5 profiled; (c) a batch-norm encoder
   (batchnorm, jk_mode="cat", fp32): three train-mode passes on the module
   through the cached encode, each (loss, every gradient, the running
   statistics it leaves) against the plain twins, the convs' biases held
   as zero by symmetry (batch norm's mean takes them out); a train step
   refused, as the reference's raises; then its weights and statistics in
   a bf16 model through run_inference over all 100k nodes in eval mode,
   launches reset before and read after, batch 0 against the plain twins
   (3e-2 of the scale), 5 batches profiled;
23. LinkClassificationTrainer at the flagship (GraphSAGE bf16, the
   hadamard head, hidden 64, 2 classes; 100k labelled edges of the graph,
   numpy-seeded labels): step 1 against the plain twins in fp32 and bf16
   (the head's gradients too), then 3 + 20 steps of batch 512 with the
   launch counts reset just before and read just after, 5 profiled,
   evaluate over 10 batches and predict_batch;
24. SSLTrainer, each of the seven tasks in turn (GRACE, GBT, whitening,
   feature reconstruction, BGRL, TBGRL, DirectAU) on the flagship encoder
   at batch 512: step 1 in fp32 against the plain twins from one view draw
   (the head's gradients too; GBT's last conv bias and the whitening
   projector's last bias held as zero by symmetry), BGRL's and TBGRL's
   target after a step against ema_update of the online encoder (bit-equal),
   then 3 + 10 bf16 steps with the launch counts reset just before and read
   just after (DirectAU's batch adds K1b), 5 profiled. Phases 22-24 print
   host ms/step (ended by a synchronise), edges/s (counted as
   bench.py:631-638 counts them: both endpoints' trees for the link task,
   every view's tree for SSL), the profiler's device ms, busy share and top
   five ops, first and last loss, and peak memory;
25. prints the SegmentIndex host builds counted inside every timed window
   of a path (SegmentIndex.from_ids wrapped from the build on; each must
   read 0: a segment op on the card given no index builds one on the
   host), K8's gathering launches there by mode (none may be chained:
   every index is built with the very src its pass gives K8, whose
   composed mode reads the rows from the index) and K8b's over a source
   walk (none may be chained either: every source index is built with the
   very destination ids its pass gives K8b), one JSON line with every
   kernel's numbers, then the card line, then {"ok": true, ...} as the
   last line. Every profile carries K7 / K7b (attention_ms_per_step), K10
   / K8 / K8b / K9 / K9b / K10b (segment_ms_per_step), K6
   (ell_aggregate_ms_per_step, with its launches a step), K6b
   (ell_transpose_ms_per_step), K15 (route_ms_per_step) and K17
   (ring_ms_per_step) device ms. K8's and K8b's rows time their
   composed mode (ms) beside their chained mode (chained_ms: a copy of src
   or of the segment ids), bit-equal.

Any failed check raises; nothing is printed as a result without a card.
It imports neither JAX nor the JAX package.
"""

import contextlib
import copy
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
N, E, D = 100_000, 2_000_000, 128
HID, OUT, BATCH = 256, 128, 512
R = 512                     # random negatives per step
FANOUTS = (15, 10)
STEPS, WARMUP, PROFILED = 200, 5, 20
# The kernels each main path runs.
INFERENCE_KERNELS = ("sample_uniform", "build_neighbor_cache", "gather_rows",
                     "masked_reduce")
TRAINING_KERNELS = ("sample_uniform", "uniform_ids", "build_neighbor_cache",
                    "gather_rows", "masked_reduce", "masked_reduce_bwd",
                    "retrieval_loss")
FULL_GRAPH_KERNELS = {"graphsage": ("gather_rows", "ell_aggregate"),
                      "gat": ("gather_rows", "fanout_attention")}
GAT_HEADS = 4               # examples/baseline_milestones.py:91
FULL_GRAPH_PROFILED = 3     # passes under torch.profiler
C = 16                      # classes (_ell_bench.py:15)
FB_STEPS, FB_WARMUP, FB_PROFILED = 50, 3, 5
FULL_BATCH_KERNELS = {
    "graphsage": ("gather_rows", "ell_aggregate", "ell_transpose_aggregate"),
    "gat": ("gather_rows", "fanout_attention", "fanout_attention_bwd",
            "ell_transpose_aggregate")}
# examples/baseline_milestones.py:86-94 (GAT), and GraphSAGE at (15, 10)
NC_MODELS = {"gat": (3, (15, 10, 5), {"heads": 4}),
             "graphsage": (2, (15, 10), None)}
NC_HID, NC_BATCH, NC_LR = 64, 256, "0.005"
NC_STEPS, NC_WARMUP, NC_PROFILED = 50, 3, 5
NC_LABELED = 4              # batches of labeled nodes, cycled
COO_KERNELS = {
    "graphsage": ("segment_reduce", "segment_reduce_bwd"),
    "gat": ("gather_rows", "segment_reduce", "segment_reduce_bwd",
            "segment_softmax", "segment_softmax_bwd", "sddmm"),
    "transformer": ("sddmm", "segment_softmax", "segment_reduce",
                    "segment_reduce_bwd", "segment_softmax_bwd",
                    "sddmm_bwd")}
NC_KERNELS = {
    "graphsage": ("sample_uniform", "gather_rows", "masked_reduce",
                  "masked_reduce_bwd"),
    "gat": ("sample_uniform", "gather_rows", "fanout_attention",
            "fanout_attention_bwd")}
# the typed graph and model (examples/configs/dblp_hetero_nalp_task_config
# .yaml: author / paper, three edge types, HGT, 4 heads, hidden 128, out 64,
# 2 layers; the scale of bench.py:593-615)
HET_AUTHORS, HET_PAPERS = 50_000, 100_000
HET_WRITES, HET_CITES = 400_000, 1_000_000
HET_HID, HET_OUT, HET_HEADS, HET_BASES = 128, 64, 4, 2
WRITES, REV_WRITES, CITES = ("author-writes-paper", "paper-rev_writes-author",
                             "paper-cites-paper")
# the yaml's message_passing_paths: (op, edge type, fanout, parent op)
DBLP_PATHS = {
    "paper": (("authors", WRITES, 10, None), ("cited", CITES, 10, None),
              ("coauthored", REV_WRITES, 5, "authors"),
              ("cited_authors", WRITES, 5, "cited")),
    "author": (("papers", REV_WRITES, 10, None),
               ("paper_authors", WRITES, 5, "papers"))}
TYPED_FULL_KERNELS = {"hgt": ("sddmm", "segment_softmax", "segment_reduce"),
                      "rgcn": ("segment_reduce",)}
TYPED_SAMPLED_KERNELS = ("sample_uniform", "gather_rows", "fanout_attention")
TYPED_PROFILED = 3
# typed NALP training (the yaml's: batch 512, 1 positive, 512 random
# negatives, retrieval at temperature 0.07, Adam 1e-3)
TT_STEPS, TT_WARMUP, TT_PROFILED, TT_EVAL_BATCHES = 100, 5, 5, 4
TYPED_TRAIN_KERNELS = {
    "hgt": ("sample_uniform", "uniform_ids", "gather_rows",
            "fanout_attention", "fanout_attention_bwd", "retrieval_loss"),
    "rgcn": ("sample_uniform", "uniform_ids", "gather_rows", "masked_reduce",
             "masked_reduce_bwd", "retrieval_loss")}
# edge features (phase 11): EDGE_DE features per edge (ogbn-proteins'
# width); GINE's hidden width equals D (it adds the projected edge rows to
# the node rows)
EDGE_DE, EDGE_GINE_HID, EDGE_HARD = 8, 128, 500_000
EDGE_NALP_STEPS, EDGE_TYPED_STEPS = 50, 50
EDGE_FULL_GRAPH = {       # model: (conv, hidden, conv_kwargs, kernels)
    "gine": ("gine", EDGE_GINE_HID, None, ("gather_rows", "ell_aggregate")),
    "edge_attr_gat": ("edge_attr_gat", HID, {"heads": 4},
                      ("gather_rows", "fanout_attention")),
    "transformer": ("transformer", HID, {"heads": 4, "use_edge_attr": True},
                    ("gather_rows", "fanout_attention")),
    "gatv2_edges": ("gatv2", HID, {"heads": 4, "use_edge_attr": True},
                    ("gather_rows", "fanout_attention"))}
# GATv2 with edge rows (ROADMAP B6b): the edge table's gradient (K11's
# gatv2 mode) and its sum into the key table (K6b over EllGraph.t_edge)
GATV2_EDGE_ELL_MODES = ("ell_edge_grad_gatv2", "ell_transpose_edge_rows")
EDGE_FULL_BATCH = {
    "gine": ("gine", EDGE_GINE_HID, None,
             ("gather_rows", "ell_aggregate", "ell_transpose_aggregate",
              "ell_edge_grad")),
    "edge_attr_gat": ("edge_attr_gat", HID, {"heads": 4},
                      ("gather_rows", "fanout_attention",
                       "fanout_attention_bwd", "ell_transpose_aggregate",
                       "ell_edge_grad")),
    "gatv2_edges": ("gatv2", HID, {"heads": 4, "use_edge_attr": True},
                    ("gather_rows", "fanout_attention",
                     "fanout_attention_bwd", "ell_transpose_aggregate",
                     "ell_edge_grad") + GATV2_EDGE_ELL_MODES)}
EDGE_NALP_KERNELS = ("sample_uniform", "uniform_ids", "gather_rows",
                     "fanout_attention", "fanout_attention_bwd",
                     "retrieval_loss")
EDGE_TYPED_KERNELS = {
    "hgt": TYPED_TRAIN_KERNELS["hgt"],
    "simple_hgn": ("sample_uniform", "uniform_ids", "gather_rows",
                   "fanout_attention", "fanout_attention_bwd",
                   "retrieval_loss")}
# quantized tables and the logQ correction (phase 13): the flagship NALP
# path over int8 features and cache with the count-min sketch
QUANT_TRAIN_KERNELS = ("sample_uniform", "uniform_ids",
                       "build_neighbor_cache", "gather_rows", "masked_reduce",
                       "masked_reduce_bwd", "retrieval_loss",
                       "gather_rows_q8", "cms_add", "cms_estimate")
QUANT_INFERENCE_KERNELS = ("gather_rows", "gather_rows_q8", "masked_reduce")
MID_STEPS = 20              # the sketch K14 and K5's logQ mode are held on
AB_STEPS = 50               # steps per turn of the host-cost comparison
# partitioned training (phase 14): the flagship graph over PART_SHARDS
# shards sharing the one card, live sampling, capacity factor 4
PART_SHARDS, PART_CAPACITY = 4, 4.0
PART_STEPS, PART_WARMUP, PART_PROFILED = 20, 3, 5
PART_TRAIN_KERNELS = ("sample_uniform", "uniform_ids", "gather_rows",
                      "masked_reduce", "masked_reduce_bwd", "cms_add",
                      "cms_estimate", "route_requests", "unroute_rows")
PART_ENCODE_KERNELS = ("sample_uniform", "gather_rows", "masked_reduce",
                       "route_requests", "unroute_rows")
# the partitioned tier's label edges and typed trainer (phase 19): steps
# timed and profiled a path
LE_STEPS, LE_PROFILED = 10, 3
# weighted and top-k draws (phase 16): the flagship graph with an
# [E, W_DE] fp32 edge table (ogbn-proteins' width) whose column 0 holds
# uniform [0, 1) sampling weights (numpy seed W_SEED)
W_DE, W_SEED, W_WINDOW = 8, 16, 128
W_STEPS, W_WARMUP, W_PROFILED = 50, 5, 5
W_PART_STEPS, W_PART_WARMUP = 10, 3
W_TYPED_BATCHES = 10        # encode_batch batches of each node type
W_AB_STEPS = 25             # steps per turn of the weighted / uniform turns
W_HUB_ROWS, W_HUB_DEG = 1000, 1000
W_TRAIN_KERNELS = ("sample_weighted", "uniform_ids", "build_neighbor_cache",
                   "gather_rows", "masked_reduce", "masked_reduce_bwd",
                   "retrieval_loss")
# the COO per-edge terms (phase 17): phase 11's edge-featured graph over
# the COO segment ops, FullBatchTrainer(build_ell=False), fp32, 2 layers
CE_STEPS, CE_WARMUP, CE_PROFILED = 20, 3, 5
COO_EDGE_MODELS = {   # model: (conv, hidden, conv_kwargs, edge rows, kernels)
    "gine": ("gine", EDGE_GINE_HID, None, True,
             ("gather_rows", "segment_reduce", "segment_reduce_bwd",
              "ell_edge_grad", "segment_reduce_gine",
              "segment_reduce_bwd_gine", "ell_edge_grad_coo")),
    "edge_attr_gat": ("edge_attr_gat", HID, {"heads": 4}, True,
                      ("gather_rows", "segment_reduce", "segment_softmax",
                       "sddmm", "segment_reduce_bwd", "segment_softmax_bwd",
                       "ell_edge_grad", "segment_reduce_add", "sddmm_addend",
                       "ell_edge_grad_coo")),
    "transformer": ("transformer", HID, {"heads": 4, "use_edge_attr": True},
                    True, ("gather_rows", "sddmm", "segment_softmax",
                           "segment_reduce", "segment_reduce_bwd",
                           "segment_softmax_bwd", "sddmm_bwd",
                           "ell_edge_grad", "segment_reduce_add",
                           "sddmm_addend", "ell_edge_grad_coo")),
    "gatv2": ("gatv2", HID, {"heads": 4}, False,
              ("sddmm", "segment_softmax", "segment_reduce",
               "segment_reduce_bwd", "segment_softmax_bwd", "sddmm_gatv2",
               "segment_reduce_gatv2", "segment_reduce_bwd_gatv2")),
    "gatv2_edges": ("gatv2", HID, {"heads": 4, "use_edge_attr": True}, True,
                    ("gather_rows", "sddmm", "segment_softmax",
                     "segment_reduce", "segment_reduce_bwd",
                     "segment_softmax_bwd", "ell_edge_grad",
                     "sddmm_gatv2_edge", "segment_reduce_add",
                     "sddmm_addend", "segment_reduce_gatv2_edge",
                     "ell_edge_grad_gatv2", "segment_reduce_bwd_edge_rows"))}
# out-of-core training (phase 20): the flagship NALP path with its features
# in an np.memmap on local disk, streamed to the card per batch through a
# ring of STREAM_PREFETCH + 1 pinned slots
STREAM_STEPS, STREAM_WARMUP, STREAM_PROFILED = 50, 5, 5
STREAM_PARITY_STEPS, STREAM_PREFETCH = 3, 2
STREAM_KERNELS = ("masked_reduce", "masked_reduce_bwd", "retrieval_loss")
# the streamed-partitioned tier (phase 21): the flagship over PART_SHARDS
# shards with every feature row on the host; the typed and NC trainers
SP_PARITY, SP_WARMUP, SP_STEPS, SP_PROFILED = 3, 5, 30, 5
SP_TYPED_WARMUP, SP_TYPED_STEPS, SP_TYPED_PROFILED = 3, 10, 3
SP_KERNELS = ("route_requests", "unroute_rows", "gather_rows",
              "masked_reduce", "masked_reduce_bwd", "retrieval_loss")
# what the streamed step must not launch: no draw and no row gather on the
# card (the host engine drew and gathered every row)
STREAM_ABSENT = ("sample_uniform", "uniform_ids", "build_neighbor_cache",
                 "gather_rows", "gather_rows_q8")
# the encoder and decoder options (phase 22): the cached flagship step
# with JK cat, the final linear and the hadamard_mlp decoder; the live step
# with DCN, JK lstm and the mlp decoder; a batch-norm encoder's train-mode
# passes and inference
OPT_STEPS, OPT_LIVE_STEPS, OPT_WARMUP, OPT_PROFILED = 20, 10, 3, 5
OPT_DECODER_HIDDEN, BN_PASSES = 128, 3
OPT_KERNELS = ("sample_uniform", "uniform_ids", "gather_rows",
               "masked_reduce", "masked_reduce_bwd", "retrieval_loss")
# the link task (phase 23): 100k labelled edges of the flagship graph,
# numpy-seeded labels, the hadamard head
LINK_EDGES, LINK_CLASSES, LINK_HIDDEN, LINK_SEED = 100_000, 2, 64, 23
LINK_STEPS, LINK_WARMUP, LINK_EVAL_BATCHES = 20, 3, 10
LINK_KERNELS = ("sample_uniform", "gather_rows", "masked_reduce",
                "masked_reduce_bwd")
# SSL (phase 24): each task on the flagship encoder at batch 512; the
# views each step encodes (each a fanout tree's edges)
SSL_STEPS, SSL_WARMUP = 10, 3
SSL_KERNELS = ("sample_uniform", "gather_rows", "masked_reduce",
               "masked_reduce_bwd")
# biases whose gradient the loss's standardisation takes out (GBT: the
# encoder's last; the whitening: the projector's last)
SSL_SYMMETRIC = {"gbt": ("convs.1.lin_self.bias",),
                 "whitening": ("head.proj.fc2.bias",)}
SSL_VIEWS = {"grace": 2, "gbt": 2, "whitening": 2, "feature_recon": 1,
             "bgrl": 4, "tbgrl": 5, "directau": 2}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
# ReLU gates the plain step may see on the other side of 0 (fp32 rounding)
FLIPS_MAX, FLIP_NEAR_ZERO = 8, 1e-4


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def cuda_ms(fn, reps=20):
    """Device time of one ``fn`` call: ``reps`` calls captured in one CUDA
    graph, replayed and timed with CUDA events, so the host's launch cost
    is left out (``eager_ms`` measures it in)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def eager_ms(fn, reps=50):
    """Time per call of ``fn`` issued back to back from Python: bounded by
    the host's launch cost when the device work is shorter."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_launches(fn, name, lead=256):
    """The device kernels whose name holds ``name`` that one call of
    ``fn`` launches, counted by torch.profiler. ``lead`` small kernels run
    first in the profiler's recording: late in this process a recording
    drops its first few device records (about 6 in phase 13, where a lone
    call recorded none; PERF.md §6), so they fall on those."""
    from torch.autograd import DeviceType

    pad = torch.zeros(1, device=torch.device("cuda", 0))
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            pad.add_(1.0)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and name in e.name)


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def emit(obj):
    print(json.dumps(obj), flush=True)


def loads_ahead():
    """The loads ahead compiled into the attention kernels (K7, K7b): the
    pieces of max(1, kDepth / K) slots per lane, K the slot row's pieces
    per lane (csrc/gigl_attention.cuh)."""
    text = (REPO / "gigl_tpu_torch" / "csrc" / "gigl_attention.cuh"
            ).read_text()
    depth = re.search(r"constexpr int kDepth = (\d+);", text)
    check(depth is not None, "gigl_attention.cuh: no kDepth")
    return {"k_depth": int(depth.group(1)),
            "slots_ahead_per_lane": "max(1, kDepth / K)"}


# SegmentIndex.from_ids calls (each a host build: the ids copied to the
# host, a wait for the device), counted once count_host_index_builds() ran;
# a path's timed window must hold none
HOST_INDEX_BUILDS = {"calls": 0}
INDEX_BUILDS_IN_WINDOWS = {}


def count_host_index_builds():
    """Count every SegmentIndex.from_ids call from here on."""
    from gigl_tpu_torch.ops.segment import SegmentIndex

    build = SegmentIndex.from_ids.__func__

    def counted(cls, *args, **kwargs):
        HOST_INDEX_BUILDS["calls"] += 1
        return build(cls, *args, **kwargs)

    SegmentIndex.from_ids = classmethod(counted)


# K8's launches with a gather and K8b's over a source walk inside each
# path's timed windows, by mode (_build.launches' segment_reduce_composed /
# _chained and segment_reduce_bwd_composed / _chained): every one must read
# its index's composed ids
K8_GATHER_IN_WINDOWS = {}
K8B_WALK_IN_WINDOWS = {}
K8_MODES = ("composed", "chained")


@contextlib.contextmanager
def timed_window(path):
    """A path's timed steps or passes: a segment op on the card given no
    SegmentIndex builds one on the host, so none may be built inside; and
    every K8 launch with a gather (every K8b launch over a source walk)
    reads the composed ids of an index built from that very gather
    (those very segment ids): no chained launch."""
    from gigl_tpu_torch.ops import _build

    before = HOST_INDEX_BUILDS["calls"]
    kinds = (("K8", "segment_reduce", K8_GATHER_IN_WINDOWS),
             ("K8b", "segment_reduce_bwd", K8B_WALK_IN_WINDOWS))
    mode_before = {f"{k_}_{m_}": _build.launches[f"{k_}_{m_}"]
                   for _, k_, _ in kinds for m_ in K8_MODES}
    yield
    n = HOST_INDEX_BUILDS["calls"] - before
    INDEX_BUILDS_IN_WINDOWS[path] = INDEX_BUILDS_IN_WINDOWS.get(path, 0) + n
    check(n == 0, f"{path}: {n} SegmentIndex host builds inside its timed "
          "window")
    for what, kernel, table in kinds:
        seen = table.setdefault(path, dict.fromkeys(K8_MODES, 0))
        for mode in K8_MODES:
            key = f"{kernel}_{mode}"
            seen[mode] += _build.launches[key] - mode_before[key]
        check(seen["chained"] == 0, f"{path}: {seen['chained']} {what} "
              "launches read their ids through the index's order (chained "
              "mode) inside its timed window")


def profile_summary(prof, steps, window_us, host_ms_per_step):
    """Device time per step, busy share and the top device ops from a
    torch.profiler run over ``steps`` training steps."""
    from torch.autograd import DeviceType

    # Device activity: kernels, copies and sets; user annotations (such as
    # Optimizer.step) also appear on the device timeline but span others.
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not events:
        return {"device_events": 0, "device_ms_per_step": None,
                "note": "the profiler recorded no device activity"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    by_name = {}
    for e in events:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    device_ms = sum(t for t, _ in by_name.values()) / steps / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    attention = dict.fromkeys(("fanout_attention", "fanout_attention_bwd"),
                              0.0)
    segment = dict.fromkeys(("sddmm", "segment_reduce", "segment_reduce_bwd",
                             "segment_softmax", "segment_softmax_bwd",
                             "sddmm_bwd"), 0.0)
    transpose = 0.0   # K6b: its bucket walks and the max mode's tie pass
    route = 0.0       # K15: its count and write launches
    k6 = [0.0, 0]     # K6: device ms and launches a step
    ring = {"fold": 0.0, "bwd": 0.0}     # K17
    for n, (t, c) in by_name.items():
        if "ell_aggregate_kernel" in n:
            k6[0] += t / steps / 1e3
            k6[1] += c / steps
        if "ring_fold_kernel" in n:
            ring["fold"] += t / steps / 1e3
        if "ring_block_bwd_kernel" in n:
            ring["bwd"] += t / steps / 1e3
        if "ell_transpose_" in n or "tie_count_kernel" in n:
            transpose += t / steps / 1e3
        if "route_requests_" in n:
            route += t / steps / 1e3
        if "fanout_attention_bwd" in n or "sum_partials_kernel" in n:
            attention["fanout_attention_bwd"] += t / steps / 1e3
        elif "fanout_attention_" in n:
            attention["fanout_attention"] += t / steps / 1e3
        elif "sddmm_bwd" in n:
            segment["sddmm_bwd"] += t / steps / 1e3
        elif "sddmm_" in n:
            segment["sddmm"] += t / steps / 1e3
        elif "segment_reduce_bwd" in n or "segment_max_ties" in n:
            segment["segment_reduce_bwd"] += t / steps / 1e3
        elif "segment_reduce_" in n:
            segment["segment_reduce"] += t / steps / 1e3
        elif "segment_softmax_bwd" in n:
            segment["segment_softmax_bwd"] += t / steps / 1e3
        elif "segment_softmax_" in n:
            segment["segment_softmax"] += t / steps / 1e3
    return {
        "device_events": len(events),
        "device_ms_per_step": device_ms,
        "attention_ms_per_step": attention,
        "segment_ms_per_step": segment,
        "ell_transpose_ms_per_step": transpose,
        "ell_aggregate_ms_per_step": k6[0],
        "ell_aggregate_launches_per_step": k6[1],
        "ring_ms_per_step": ring,
        "route_ms_per_step": route,
        "device_busy_ms_per_step": busy / steps / 1e3,
        "busy_share_of_profiled_window": busy / window_us,
        "busy_share_of_unprofiled_step": busy / steps / 1e3
        / host_ms_per_step,
        "profiled_window_ms_per_step": window_us / steps / 1e3,
        "top5": [{"name": n[:100], "ms_per_step": t / steps / 1e3,
                  "calls_per_step": c / steps} for n, (t, c) in top]}


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper of the training, full-graph, typed, quantized,
    partitioned, sharded and COO edge paths replaced by its plain PyTorch
    twin, on
    whatever device the tensors are: the same step or pass computed
    without a kernel, on the card. The
    segment ops become their forward twins, differentiated by PyTorch's
    autograd (not the port's backward kernels); the retrieval loss runs
    its twins inside its autograd.Function."""
    from gigl_tpu_torch.losses import (
        count_min_sketch, losses, sharded_retrieval)
    from gigl_tpu_torch.models import convs, hetero_convs
    from gigl_tpu_torch.ops import (
        attention, coo_edges, ell, ell_aggregate, fanout, gather, quantized,
        retrieval, segment)
    from gigl_tpu_torch.parallel import feature_lookup, halo
    from gigl_tpu_torch.sampling import neighbor_sampler
    from gigl_tpu_torch.training import (
        dataset, dist_sampled, hetero_dataset, trainer)

    def agg_fwd(x, ell_, op, ea=None, rows=None):
        return ell_aggregate._ell_aggregate_graph_plain(x, ell_, op, ea, rows)

    def transpose(rows, ell, op, *args, **kw):
        return ell_aggregate._ell_transpose_plain(rows, ell, op, *args, **kw)

    def att_fwd(xd, ks, vs, nbr, mask, mode, heads, att, att2, slope,
                out=None, stats=None, he=None, eidx=None, bias=None):
        got = attention._fanout_attention_plain(xd, ks, vs, nbr, mask, mode,
                                                heads, att, att2, slope, he,
                                                eidx, bias)
        return got if out is None else out.copy_(got)

    def att_bwd(g, xd, ks, vs, nbr, mask, out, stats, mode, heads, att=None,
                att2=None, negative_slope=0.2, identity=False,
                same_table=False, d_xd=None, alpha=None, coef=None, he=None,
                eidx=None, bias=None):
        got = attention._fanout_attention_bwd_plain(
            g, xd, ks, vs, nbr, mask, out, mode, heads, att, att2,
            negative_slope, identity, same_table, he, eidx, bias)
        fills = {"d_xd": d_xd, "alpha": alpha, "coef": coef}
        return got._replace(**{k: b.copy_(getattr(got, k))
                               for k, b in fills.items() if b is not None})

    def rows(table, ids, row_vals=None):
        return gather._gather_rows_plain(table, ids, row_vals)

    def seg_reduce(x, ids, n, *, op="sum", src=None, weight=None,
                   index=None, src_index=None):
        return segment._segment_reduce_plain(x, ids, n, op, src, weight)

    def seg_softmax(logits, ids, n, *, index=None):
        return segment._segment_softmax_plain(logits, ids, n)

    def dot(src, dst, q, k, *, scale=None, index=None, src_index=None):
        return segment._sddmm_plain(src, dst, q, k, scale)

    def edge_rows(table, ids, *, index=None):
        return table[ids.long()]

    def edge_grad(g, ell_, mode, *, x=None, ea=None, alpha=None, coef=None,
                  vec=None, xd=None, heads=1, negative_slope=0.2):
        return ell._ell_edge_grad_plain(g, ell_, mode, x, ea, alpha, coef,
                                        vec, xd, heads, negative_slope)

    def edge_rows_sum(rows, ell_):
        return ell_aggregate._ell_edge_rows_sum_plain(rows, ell_)

    def by_source(rows, src, n, *, src_index=None):
        return segment._edge_rows_by_source_plain(rows, src, n)

    # GATv2 with edge rows (B6b): its plain forward over the valid entries
    # (ELL) or the edges (COO), differentiated by PyTorch, the kernel
    # step's leaky gates replayed under gatv2_gate_replay
    orig_att_ell = convs.fanout_attention_ell

    def att_ell(xd, ks, vs, ell_, mode, heads, att=None, att2=None,
                negative_slope=0.2, he=None):
        if mode != "gatv2" or he is None:
            return orig_att_ell(xd, ks, vs, ell_, mode, heads, att=att,
                                att2=att2, negative_slope=negative_slope,
                                he=he)
        src_, dst_, eid = ell_entries(ell_)
        h_, dh_ = heads, xd.shape[1] // heads
        return gatv2_edges_plain(
            src_, dst_, xd.shape[0], ks.reshape(-1, h_, dh_),
            xd.reshape(-1, h_, dh_), he[eid].reshape(-1, h_, dh_), att,
            negative_slope).reshape(xd.shape[0], -1)

    def coo_v2_edges(src, dst, hs, hd, he, att, *, negative_slope=0.2,
                     index=None, src_index=None):
        return gatv2_edges_plain(src, dst, hd.shape[0], hs, hd,
                                 he.reshape(src.shape[0], *hs.shape[1:]),
                                 att, negative_slope).reshape(hd.shape[0],
                                                              -1)

    # the COO per-edge terms (phase 17): forward twins, PyTorch's autograd
    def coo(src, dst, x, n, *, edge_weight=None, reduce="sum", index=None,
            src_index=None, edge_rows=None, edge_mode="add"):
        if edge_rows is not None and edge_mode == "gine":
            coo_gate_record(x, edge_rows)
        return segment._segment_reduce_plain(
            x, dst, n, reduce, src, edge_weight, edge_rows,
            None if edge_rows is None else edge_mode)

    def gatv2(src, dst, hs, hd, att, *, negative_slope=0.2, index=None,
              src_index=None):
        if GATV2_GATES is None:
            return segment._sddmm_plain(src, dst, hd, hs, att=att,
                                        negative_slope=negative_slope)
        # the kernel step's leaky gates, replayed (see gatv2_gate_replay)
        z = hs.float()[src.long()] + hd.float()[dst.long()]
        m = GATV2_GATES["masks"][GATV2_GATES["i"]]
        GATV2_GATES["i"] += 1
        flip = (z >= 0) != m
        GATV2_GATES["flips"] += int(flip.sum())
        GATV2_GATES["gates"] += m.numel()
        if bool(flip.any()):
            GATV2_GATES["near"] = max(GATV2_GATES["near"], float(
                z[flip].abs().max() / z.abs().max()))
        return (torch.where(m, z, negative_slope * z)
                * att.float()).sum(-1).to(hd.dtype)

    def gat_edges(src, dst, n, hs, he, pre, att_src, *, negative_slope=0.2,
                  index=None, src_index=None):
        e, (_, h, dh) = src.shape[0], hs.shape
        he3 = he.reshape(e, h, dh)
        z = pre + (he3 * att_src.to(he.dtype)).sum(-1)
        coo_gate_record(z)
        alpha = segment._segment_softmax_plain(
            torch.where(z >= 0, z, negative_slope * z), dst, n)
        return segment._segment_reduce_plain(hs, dst, n, "sum", src, alpha,
                                             he3, "add").reshape(n, h * dh)

    def transformer_edges(src, dst, q, k, v, he, scale, *, index=None,
                          src_index=None):
        e, (n, h, dh) = src.shape[0], q.shape
        he3 = he.reshape(e, h, dh)
        alpha = segment._segment_softmax_plain(
            segment._sddmm_plain(src, dst, q, k, scale, edge=he3), dst, n)
        return segment._segment_reduce_plain(v, dst, n, "sum", src, alpha,
                                             he3, "add").reshape(n, h * dh)

    patches = [
        (ell_aggregate, "_ell_aggregate_fwd", agg_fwd),
        (ell_aggregate, "ell_transpose_aggregate", transpose),
        (attention, "ell_transpose_aggregate", transpose),
        (attention, "_fanout_attention_fwd", att_fwd),
        (attention, "fanout_attention_bwd", att_bwd),
        (attention, "ell_edge_grad", edge_grad),
        (ell_aggregate, "ell_edge_grad", edge_grad),
        (gather, "gather_rows", rows), (dataset, "gather_rows", rows),
        (fanout, "_masked_reduce_fwd", fanout._masked_reduce_plain),
        (fanout, "masked_reduce_bwd", fanout._masked_reduce_bwd_plain),
        (neighbor_sampler, "sample_uniform",
         neighbor_sampler._sample_uniform_plain),
        (neighbor_sampler, "sample_weighted",
         neighbor_sampler._sample_weighted_plain),
        (segment, "segment_reduce", seg_reduce),
        (hetero_convs, "segment_softmax", seg_softmax),
        (hetero_convs, "sddmm", dot), (hetero_convs, "gather_edges", edge_rows),
        (convs, "segment_softmax", seg_softmax), (convs, "sddmm", dot),
        (convs, "gather_edges", edge_rows), (convs, "coo_spmm", coo),
        (convs, "gatv2_scores", gatv2), (convs, "coo_gat_edges", gat_edges),
        (convs, "coo_transformer_edges", transformer_edges),
        (convs, "coo_gatv2_edges", coo_v2_edges),
        (convs, "fanout_attention_ell", att_ell),
        (attention, "ell_edge_rows_sum", edge_rows_sum),
        (coo_edges, "edge_rows_by_source", by_source),
        (hetero_dataset, "gather_rows", rows),
        (hetero_dataset, "expand_table", gather._expand_table_plain),
        (dataset, "uniform_ids", neighbor_sampler._uniform_ids_plain),
        (losses, "retrieval_fwd", retrieval._retrieval_fwd_plain),
        (losses, "retrieval_bwd", retrieval._retrieval_bwd_plain),
        (dataset, "expand_table", gather._expand_table_plain),
        (quantized, "gather_rows_q8", quantized._gather_rows_q8_plain),
        (quantized, "gather_rows_q8_many",
         quantized._gather_rows_q8_many_plain),
        (trainer, "cms_add", count_min_sketch._cms_add_plain),
        (trainer, "cms_sampling_probability",
         count_min_sketch._cms_probability_plain),
        (feature_lookup, "route_requests",
         feature_lookup._route_requests_plain),
        (feature_lookup, "unroute_rows", feature_lookup._unroute_plain),
        (feature_lookup, "unroute_rows_q8", feature_lookup._unroute_q8_plain),
        (feature_lookup, "gather_packed_rows_q8",
         quantized._gather_packed_rows_q8_plain),
        (dist_sampled, "expand_table", gather._expand_table_plain),
        (feature_lookup, "sample_uniform",
         neighbor_sampler._sample_uniform_plain),
        (feature_lookup, "sample_weighted",
         neighbor_sampler._sample_weighted_plain),
        (feature_lookup, "gather_rows", rows),
        (dist_sampled, "cms_add", count_min_sketch._cms_add_plain),
        (dist_sampled, "cms_sampling_probability",
         count_min_sketch._cms_probability_plain),
        (sharded_retrieval, "ring_fold", sharded_retrieval._ring_fold_plain),
        (sharded_retrieval, "ring_block_bwd",
         sharded_retrieval._ring_block_bwd_plain),
        (halo, "ring_spmm_bucket", halo._ring_spmm_bucket_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, f in patches:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def step_vs_plain(model, loss_fn, launches, gated=True, symmetric=(),
                  extra=None, explain=None):
    """One step's loss and gradients through the kernels and again through
    the plain twins (no kernel may launch), from the same weights: the
    loss's relative error and each parameter's max gradient error over its
    scale. ``extra``: more leaf tensors {name: tensor} whose gradients are
    held the same way (an edge-feature table, a scorer outside ``model``).
    ``explain(name, kernel_grad, plain_grad, scale)``: for such a tensor
    whose error passes 1e-4 of its scale, returns the mask of rows whose
    difference a recorded cause accounts for (a gate on the two sides of 0
    in the two steps, see ``edge_gate_flips``) and a report; the error is
    then taken over the other rows. ``symmetric``: the names of parameters
    whose gradient is zero by symmetry (held to 1e-2 of the largest
    gradient instead, see below).
    ``gated``: the model's ``activation`` is a ReLU (the typed
    models have none: HGT's GELU is smooth, RGCN has no activation); the
    ReLUs inside GIN's and GINE's MLPs are gated with it. The plain step
    reuses the kernel step's ReLU gates: the two
    forwards round differently, and a pre-activation within an fp32 ulp of
    0 may take the other side of the gate there, which moves a layer-1
    weight gradient by ~1/sqrt(rows) of its scale (one row's share of the
    sum) — not a kernel error. So the flipped gates are bounded: at most
    FLIPS_MAX or one per million gates, and each flipped pre-activation
    within FLIP_NEAR_ZERO of its layer's largest (a forward that disagrees
    in sign anywhere else fails)."""
    gates, flips, near = [], [], []

    def record(x):
        m = x > 0
        gates.append(m)
        return x * m                       # relu, with relu's gradient

    def replay(x):
        m = gates[len(flips)]
        flip = (x > 0) != m
        flips.append(int(flip.sum()))
        near.append(float(x[flip].abs().max() / x.abs().max())
                    if flips[-1] else 0.0)
        return x * m

    from gigl_tpu_torch.models import convs as convs_mod

    functional = convs_mod.F

    class Gated:
        """torch.nn.functional with ``relu`` recorded or replayed: the ReLU
        inside GIN's and GINE's MLPs (``GINConv._mlp``)."""

        def __init__(self, relu):
            self.relu = relu

        def __getattr__(self, name):
            return getattr(functional, name)

    act = getattr(model, "activation", None)
    leaves = dict(model.named_parameters())
    leaves.update(extra or {})

    def zero_grad():
        for t in leaves.values():
            t.grad = None

    zero_grad()
    if gated:
        model.activation = record
        convs_mod.F = Gated(record)
    loss_k = loss_fn()
    loss_k.backward()
    grads = {n: p.grad.detach().clone() for n, p in leaves.items()}
    zero_grad()
    before = dict(launches)
    if gated:
        model.activation = replay
        convs_mod.F = Gated(replay)
    with plain_kernels():
        loss_p = loss_fn()
        loss_p.backward()
    if gated:
        model.activation = act
        convs_mod.F = functional
    torch.cuda.synchronize()
    check(dict(launches) == before, "the plain step launched a kernel")
    check(len(flips) == len(gates), "the plain step's gates differ")
    n_gates = int(sum(int(m.numel()) for m in gates))
    check(sum(flips) <= max(FLIPS_MAX, n_gates // 10**6),
          f"{sum(flips)} of {n_gates} ReLU gates flipped in the plain step")
    worst = max(near, default=0.0)
    check(worst <= FLIP_NEAR_ZERO, f"a flipped ReLU gate's pre-activation "
          f"is {worst} of its layer's scale from 0")
    # each error over its parameter's own scale; a parameter named in
    # ``symmetric`` has a gradient that is zero by symmetry, so rounding
    # noise on both sides: it must be below 1e-3 of the largest, and its
    # error is taken over 1e-2 of the largest instead
    largest = max(float(g_.abs().max()) for g_ in grads.values())
    floor = 1e-2 * largest
    errs, exempt, explained = {}, {}, {}
    for n, p in leaves.items():
        check(p.grad is not None, f"plain step: no gradient for {n}")
        scale = float(p.grad.abs().max())
        err = float((grads[n] - p.grad).abs().max())
        if explain is not None and n in (extra or {}) and err > 1e-4 * scale:
            rows, explained[n] = explain(n, grads[n], p.grad, scale)
            err = float((grads[n] - p.grad)[~rows].abs().max()) if bool(
                (~rows).any()) else 0.0
        if n in symmetric:
            check(scale <= 1e-3 * largest, f"plain step: {n}'s gradient "
                  f"({scale}) is not zero by symmetry (largest {largest})")
            exempt[n] = scale / largest
            errs[n] = err / floor
        else:
            check(scale > 0, f"plain step: no gradient for {n}")
            errs[n] = err / scale
    check(set(exempt) == set(symmetric),
          f"plain step: no parameters {sorted(set(symmetric) - set(exempt))}")
    zero_grad()
    lk, lp = float(loss_k.detach()), float(loss_p.detach())
    return {"loss": lk, "loss_plain": lp, "grad_floor": floor,
            "symmetric_grad_rel_to_largest": exempt,
            "explained_rows": explained,
            "loss_rel_err": abs(lk - lp) / abs(lp),
            "grad_err_rel_to_scale": errs,
            "max_grad_err_rel_to_scale": max(errs.values()),
            "relu_gates": n_gates,
            "relu_gates_flipped_in_plain_forward": sum(flips),
            "flipped_preactivation_rel_to_scale": worst}


class Sink:
    """An exporter that keeps the rows it is given."""

    def __init__(self):
        self.ids, self.embs = [], []

    def add_embeddings(self, ids, emb):
        self.ids.append(np.asarray(ids))
        self.embs.append(emb)

    def flush(self):
        pass

    def table(self, n, width, what):
        """The exported rows in id order, checked: every id in [0, n)
        exactly once, [n, width], finite."""
        ids = np.concatenate(self.ids)
        embs = np.concatenate(self.embs)
        check(np.array_equal(np.sort(ids), np.arange(n)),
              f"{what}: exported ids are not every node exactly once")
        check(embs.shape == (n, width) and np.isfinite(embs).all(),
              f"{what}: embeddings are not finite [{n}, {width}]")
        return embs[np.argsort(ids)]


SDDMM_LIBRARY_CALL = (
    "torch.sparse.sampled_addmm, batched over heads (CSR of the in-edges, "
    "built beforehand, not timed; the per-head scale not applied)")


def sddmm_library(index, src, q, k, scale, got, rel_err):
    """K10's yardstick: torch.sparse.sampled_addmm batched over the heads
    of q, k [N, H, dk], over the CSR of the destination ``index`` (built
    here, not timed), checked against K10's scores ``got``. Returns (ms,
    None), or (None, why) where cuSPARSE refuses the shape."""
    h, e = q.shape[1], index.num_edges
    order = index.order.long()
    mask = torch.sparse_csr_tensor(
        index.ptr.long().expand(h, -1).contiguous(),
        src.long()[order].expand(h, -1).contiguous(),
        torch.zeros((h, e), device=q.device), (h, q.shape[0], k.shape[0]))
    q_h = q.transpose(0, 1).contiguous()
    k_h = k.permute(1, 2, 0).contiguous()

    def library():
        return torch.sparse.sampled_addmm(mask, q_h, k_h, beta=0.0)

    try:    # a yardstick only: cuSPARSE may refuse the batched shape
        rel_err(library().values() * scale[:, None], got[order].T,
                "sampled_addmm yardstick vs K10", tol=1e-5)
        return cuda_ms(library), None
    except RuntimeError as exc:
        return None, f"sampled_addmm failed: {exc}"[:200]


def k8_modes_checked(composed, chained, what, kernel="segment_reduce"):
    """K8's (K8b's) output through its composed mode (``composed()``: src
    (the segment ids) is the tensor the index was built from) and its
    chained mode (``chained()``: a copy of it), checked to have run in
    those modes and to agree bit for bit, and a repeat composed run too;
    returns the output."""
    from gigl_tpu_torch.ops import _build

    def modes():
        return tuple(_build.launches[f"{kernel}_{m_}"] for m_ in K8_MODES)

    before = modes()
    got = composed()
    check(modes() == (before[0] + 1, before[1]),
          f"{what}: the index's own ids did not run the composed mode")
    other = chained()
    check(modes() == (before[0] + 1, before[1] + 1),
          f"{what}: a copy of the ids did not run the chained mode")
    check(torch.equal(got, other), f"{what}: composed and chained differ")
    check(torch.equal(got, composed()), f"{what}: a repeat run differs")
    return got


def segment_walk_rows(dev, fb, rel_err, unique):
    """K10 sddmm and K8 segment_reduce at the COO Transformer's two layers
    (the flagship's 2M edges in their random order, destination-sorted by
    the step's SegmentIndex): q, k and v [N, 4, 64] fp32 (layer 1) and
    [N, 4, 4] (layer 2), K10 scaled by 1 / sqrt(dk), K8 summing the v
    rows weighted per head by an [E, 4] alpha, as coo_spmm does in the
    step. Each against its plain twin (fp32: 1e-5), the same bits on a
    repeat run, its bound, its library yardstick (K10:
    sparse.sampled_addmm; K8: sparse.mm, the unweighted sum, whose kernel
    time is beside it) and gathered_bytes, E x the bytes of a gathered
    row, which the byte bound counts once per distinct row. K8 runs
    composed (the step's index was built from its src: ms, sum_ms) and
    chained (a copy of src: chained_ms, chained_sum_ms), bit-equal.
    Returns {kernel: {mode: numbers}} for the kernel rows."""
    from gigl_tpu_torch.ops.segment import (
        _sddmm_plain, _segment_reduce_plain, sddmm, segment_reduce)

    idx, src, dst = fb.index, fb.src, fb.dst
    src_copy = src.clone()   # the same ids in another tensor: chained mode
    e, n, h = idx.num_edges, idx.num_segments, GAT_HEADS
    u_src, u_dst = unique(src), unique(dst)
    order = idx.order.long()
    gen = torch.Generator(device=dev).manual_seed(14)
    adj = torch.sparse_csr_tensor(idx.ptr.long(), src.long()[order],
                                  torch.ones(e, device=dev), (n, n))
    rows = {"sddmm": {}, "segment_reduce": {}}
    for layer, dk in (("coo_layer1", HID // h), ("coo_layer2", C // h)):
        c = h * dk
        q, k, v = (torch.randn((n, h, dk), generator=gen, device=dev)
                   for _ in range(3))
        scale = torch.full((h,), dk ** -0.5, device=dev)
        alpha = torch.rand((e, h), generator=gen, device=dev)

        def k10():
            return sddmm(src, dst, q, k, scale=scale, index=idx)

        def k10_plain():
            return _sddmm_plain(src, dst, q, k, scale)

        got = k10()
        err = rel_err(got, k10_plain(), f"K10 {layer}", tol=1e-5)
        check(torch.equal(got, k10()), f"K10 {layer}: a repeat run differs")
        lib_ms, lib_note = sddmm_library(idx, src, q, k, scale, got, rel_err)
        # bytes: each distinct q and k row once, src and dst, the scores
        # written; ops: a multiply-add per value
        b, by = bound_ms((u_src + u_dst) * c * 4 + e * 8 + e * h * 4,
                         e * c * 2)
        rows["sddmm"][layer] = {
            "err": err, "ms": cuda_ms(k10), "plain_ms": cuda_ms(k10_plain,
                                                             reps=3),
            "eager_ms": eager_ms(k10), "bound_ms": b, "bound_by": by,
            "gathered_bytes": e * c * 4, "library_ms": lib_ms,
            "library_call": lib_note or SDDMM_LIBRARY_CALL, "edges": e,
            "heads": h, "head_dim": dk}
        del got

        def k8(weight=alpha, src=src):
            return segment_reduce(v, dst, n, src=src, weight=weight,
                                  index=idx)

        def k8_plain():
            return _segment_reduce_plain(v, dst, n, "sum", src, alpha)

        def k8_chained(weight=alpha):
            return k8(weight, src_copy)

        got = k8_modes_checked(k8, k8_chained, f"K8 {layer}")
        err = rel_err(got, k8_plain(), f"K8 {layer}", tol=1e-5)
        v2 = v.reshape(n, c)
        rel_err(torch.sparse.mm(adj, v2), k8(None).reshape(n, c),
                f"sparse.mm yardstick vs K8 sum {layer}", tol=1e-5)
        # bytes: each distinct v row once, the index's pointers, gathered
        # ids and order (to find each edge's weights), the [E, 4] weights,
        # [N, C] written; ops: a multiply and an add per edge and value
        b, by = bound_ms(u_src * c * 4 + e * 8 + (n + 1) * 4 + n * c * 4
                         + e * h * 4, e * c * 2)
        rows["segment_reduce"][layer] = {
            "err": err, "ms": cuda_ms(k8), "plain_ms": cuda_ms(k8_plain,
                                                            reps=3),
            "eager_ms": eager_ms(k8), "bound_ms": b, "bound_by": by,
            "gathered_bytes": e * c * 4,
            "library_ms": cuda_ms(lambda: torch.sparse.mm(adj, v2)),
            "library_call": "torch.sparse.mm (CSR of the in-edges, fp32) = "
                            "the unweighted sum (sum_ms)",
            "sum_ms": cuda_ms(lambda: k8(None)),
            "chained_ms": cuda_ms(k8_chained),
            "chained_sum_ms": cuda_ms(lambda: k8_chained(None)),
            "edges": e, "heads": h, "head_dim": dk}
        del got, q, k, v, v2, alpha
    del adj
    rows["segment_softmax"] = k9_coo_rows(dev, idx, dst, rel_err)
    return rows


def k9_coo_rows(dev, idx, dst, rel_err):
    """K9 segment_softmax at the COO GAT and Transformer steps' shape: [E, 4]
    logits over the flagship's 2M edges (random order, the step's
    destination index), fp32 and bf16, each against its plain twin (fp32
    1e-5; bf16 one rounding, 2**-8 of the largest alpha), the same bits on
    a repeat run, with its bound (bytes: the logits, order and ptr read
    once, alpha written once) and gathered_bytes (the 32-byte sectors a
    walk in random edge order touches: one a slot for the logits' read
    and one for alpha's write). The fp32 softmax in PyTorch is the
    library yardstick."""
    from gigl_tpu_torch.ops.segment import (
        _segment_softmax_plain, segment_softmax)

    e, n, h = idx.num_edges, idx.num_segments, GAT_HEADS
    gen = torch.Generator(device=dev).manual_seed(16)
    dst_l = dst.long()
    idx_h = dst_l[:, None].expand(e, h)
    out = {}
    for mode, dtype, tol in (("coo_fp32", torch.float32, 1e-5),
                             ("coo_bf16", torch.bfloat16, 2.0 ** -8)):
        lg = (torch.randn((e, h), generator=gen, device=dev) * 3).to(dtype)

        def k9(lg=lg):
            return segment_softmax(lg, dst, n, index=idx)

        def k9_plain(lg=lg):
            return _segment_softmax_plain(lg, dst, n)

        got = k9()
        err = rel_err(got, k9_plain(), f"K9 {mode}", tol=tol)
        check(torch.equal(got, k9()), f"K9 {mode}: a repeat run differs")
        esize = lg.element_size()
        b, by = bound_ms(e * h * esize * 2 + e * 4 + (n + 1) * 4, e * h * 5)
        entry = {"err": err, "ms": cuda_ms(k9),
                 "plain_ms": cuda_ms(k9_plain, reps=3),
                 "eager_ms": eager_ms(k9), "bound_ms": b, "bound_by": by,
                 "gathered_bytes": 2 * e * 32, "edges": e, "heads": h,
                 "dtype": str(dtype).split(".")[-1]}
        if dtype == torch.float32:
            def k9_library(lg=lg):
                m_ = torch.full((n, h), float("-inf"), device=dev)
                m_.scatter_reduce_(0, idx_h, lg, "amax")
                ex_ = torch.exp(lg - m_[dst_l])
                den = torch.zeros((n, h), device=dev).index_add_(0, dst_l,
                                                                 ex_)
                return ex_ / den[dst_l]

            rel_err(k9_library(), got, f"torch composition vs K9 {mode}",
                    tol=2e-5)
            entry["library_ms"] = cuda_ms(k9_library)
            entry["library_call"] = ("the softmax in PyTorch: "
                                     "scatter_reduce_(amax), the shift and "
                                     "exp, index_add_ of the exps, the "
                                     "division")
        out[mode] = entry
        del lg, got
    return out


def typed_phases(dev, card, record, rel_err, unique):
    """Phase 10 (see the module docstring): the typed graph, the segment
    kernels K8-K10, the exact typed passes (HGT, RGCN), the sampled typed
    HGT path (live, tabularized) and typed NALP training (HGT, RGCN).
    Returns {path: launch counts}."""
    from gigl_tpu_torch.graph.csr import HeteroGraph
    from gigl_tpu_torch.inference.inferencer import (
        InferenceConfig, node_batches, run_full_graph_inference_hetero)
    from gigl_tpu_torch.models.hetero_convs import TypedSegments
    from gigl_tpu_torch.models.hetero_encoders import HeteroGNNEncoder
    from gigl_tpu_torch.models.init import init_params
    from gigl_tpu_torch.models.link_prediction import (
        HeteroLinkPredictionGNN, LinkPredictionDecoder)
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.ops.segment import (
        _sddmm_plain, _segment_reduce_plain, _segment_softmax_plain, sddmm,
        segment_reduce, segment_softmax)
    from gigl_tpu_torch.sampling.hetero_sampler import (
        SamplingOp, resolve_path)
    from gigl_tpu_torch.training.hetero_dataset import HeteroDeviceGraph
    from gigl_tpu_torch.training.hetero_trainer import (
        HeteroNALPTrainer, HeteroNALPTrainerConfig)
    from gigl_tpu_torch.types.graph import EdgeType, GraphMetadata

    # -- the typed graph (numpy seed 0) ---------------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    num_nodes = {"author": HET_AUTHORS, "paper": HET_PAPERS}
    w_src = rng.integers(0, HET_AUTHORS, HET_WRITES)
    w_dst = rng.integers(0, HET_PAPERS, HET_WRITES)
    c_src = rng.integers(0, HET_PAPERS, HET_CITES)
    c_dst = rng.integers(0, HET_PAPERS, HET_CITES)
    feats = {nt: rng.normal(size=(n, D)).astype(np.float32)
             for nt, n in num_nodes.items()}
    edge_types = (WRITES, REV_WRITES, CITES)
    graph = HeteroGraph(
        metadata=GraphMetadata(("author", "paper"), edge_types),
        num_nodes=num_nodes,
        edges={EdgeType.from_str(WRITES): np.stack([w_src, w_dst]),
               EdgeType.from_str(REV_WRITES): np.stack([w_dst, w_src]),
               EdgeType.from_str(CITES): np.stack([c_src, c_dst])},
        node_features=feats)
    n_nodes = HET_AUTHORS + HET_PAPERS
    n_edges = 2 * HET_WRITES + HET_CITES
    emit({"phase": "typed_graph", "seconds": time.perf_counter() - t0,
          "nodes": num_nodes, "edges": n_edges,
          "device_bytes": sum(f.nbytes for f in feats.values())
          + n_edges * 2 * 4})
    edges_np = {str(et): (coo[0], coo[1]) for et, coo in graph.edges.items()}
    # inference builds the forward's indexes; a gradient also walks the
    # source-sorted and per-relation ones
    seg_s, seg_bwd_s = {}, {}
    for by in ("dst", "relation"):
        for backward, into in ((False, seg_s), (True, seg_bwd_s)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            built = TypedSegments.build(edges_np, num_nodes, by, dev,
                                        backward=backward)
            torch.cuda.synchronize()
            into[by] = time.perf_counter() - t0
            if by == "dst" and not backward:
                seg_dst = built
    emit({"phase": "segment_index", "build_s": seg_s,
          "build_s_with_backward": seg_bwd_s,
          "in_edges": {nt: i.num_edges for nt, i in seg_dst.index.items()}})

    # -- K8, K9, K10 at the papers' 1.4M in-edges, H*dk = 128, fp32 -----------
    idx = seg_dst.index["paper"]
    src_p, dst_p = seg_dst.src_stack["paper"], seg_dst.dst_ids["paper"]
    e_p, h, dk = idx.num_edges, HET_HEADS, HET_HID // HET_HEADS
    gen = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn((HET_PAPERS, h, dk), generator=gen, device=dev)
    kr, msg = (torch.randn((n_nodes, h, dk), generator=gen, device=dev)
               for _ in range(2))
    scale = torch.full((h,), dk ** -0.5, device=dev)
    u_src, u_dst = unique(src_p), unique(dst_p)
    order = idx.order.long()

    def k10():
        return sddmm(src_p, dst_p, q, kr, scale=scale, index=idx)

    def k10_plain():
        return _sddmm_plain(src_p, dst_p, q, kr, scale)

    logits = k10()
    err10 = rel_err(logits, k10_plain(), "K10 sddmm", tol=1e-5)
    lib10_ms, lib10_note = sddmm_library(idx, src_p, q, kr, scale, logits,
                                         rel_err)
    # bytes: each distinct q and k row read once, src and dst, the scores
    # written; ops: a multiply-add per value. gathered_bytes: the k rows
    # the walk reads, one an edge
    record("sddmm", "gigl_tpu_torch/csrc/sddmm.cu",
           "gigl_tpu/ops/segment.py:90", err10, cuda_ms(k10),
           cuda_ms(k10_plain, reps=3),
           nbytes=(u_src + u_dst) * HET_HID * 4 + e_p * 8 + e_p * h * 4,
           nops=e_p * HET_HID * 2, library_ms=lib10_ms,
           library_call=lib10_note or SDDMM_LIBRARY_CALL,
           gathered_bytes=e_p * HET_HID * 4,
           edges=e_p, heads=h, head_dim=dk, eager_ms=eager_ms(k10))

    def k9():
        return segment_softmax(logits, dst_p, HET_PAPERS, index=idx)

    def k9_plain():
        return _segment_softmax_plain(logits, dst_p, HET_PAPERS)

    alpha = k9()
    err9 = rel_err(alpha, k9_plain(), "K9 segment_softmax", tol=1e-5)
    dst_l = dst_p.long()
    idx_h = dst_l[:, None].expand(e_p, h)

    def k9_library():
        m_ = torch.full((HET_PAPERS, h), float("-inf"), device=dev)
        m_.scatter_reduce_(0, idx_h, logits, "amax")
        ex_ = torch.exp(logits - m_[dst_l])
        den = torch.zeros((HET_PAPERS, h), device=dev).index_add_(0, dst_l,
                                                                   ex_)
        return ex_ / den[dst_l]

    rel_err(k9_library(), alpha, "torch composition vs K9", tol=2e-5)

    # bytes: the logits and the index read once, alpha written; ops: max,
    # subtract, exp, add and divide per (edge, head)
    record("segment_softmax", "gigl_tpu_torch/csrc/segment_softmax.cu",
           "gigl_tpu/ops/segment.py:51", err9, cuda_ms(k9),
           cuda_ms(k9_plain, reps=3),
           nbytes=e_p * h * 4 * 2 + e_p * 4 + (HET_PAPERS + 1) * 4,
           nops=e_p * h * 5, library_ms=cuda_ms(k9_library),
           library_call="the softmax in PyTorch: scatter_reduce_(amax), "
           "the shift and exp, index_add_ of the exps, the division",
           edges=e_p, heads=h, eager_ms=eager_ms(k9))
    del idx_h

    k8 = {}
    src_copy = src_p.clone()   # the same ids in another tensor: chained
    for mode, op, w in (("weighted", "sum", alpha), ("sum", "sum", None),
                        ("mean", "mean", None), ("max", "max", None)):
        def k8_kernel(op=op, w=w, src=src_p):
            return segment_reduce(msg, dst_p, HET_PAPERS, op=op, src=src,
                                  weight=w, index=idx)

        def k8_plain(op=op, w=w):
            return _segment_reduce_plain(msg, dst_p, HET_PAPERS, op, src_p, w)

        def k8_chained(op=op, w=w):
            return k8_kernel(op, w, src_copy)

        err = rel_err(k8_modes_checked(k8_kernel, k8_chained,
                                       f"K8 typed {mode}"),
                      k8_plain(), f"K8 {mode}", tol=1e-5)
        # bytes: each distinct source row read once, the index's pointers
        # and gathered ids (weighted: + its order, to find each edge's
        # weights, and the [E, H] weights), [S, C] written; ops: an add
        # (and a multiply) per edge and value
        nbytes = (u_src * HET_HID * 4 + e_p * 4 + (HET_PAPERS + 1) * 4
                  + HET_PAPERS * HET_HID * 4 + (e_p * 4 + e_p * h * 4
                                                if w is not None else 0))
        nops = e_p * HET_HID * (2 if w is not None else 1)
        k8[mode] = {"err": err, "ms": cuda_ms(k8_kernel),
                    "chained_ms": cuda_ms(k8_chained),
                    "plain_ms": cuda_ms(k8_plain, reps=3),
                    "eager_ms": eager_ms(k8_kernel),
                    "bound_ms": bound_ms(nbytes, nops)[0],
                    "gathered_bytes": e_p * HET_HID * 4,
                    "nbytes": nbytes, "nops": nops}
    adj = torch.sparse_csr_tensor(
        idx.ptr.long(), src_p.long()[order],
        torch.ones(e_p, device=dev), (HET_PAPERS, n_nodes))
    msg2 = msg.reshape(n_nodes, HET_HID)
    rel_err(torch.sparse.mm(adj, msg2), segment_reduce(
        msg, dst_p, HET_PAPERS, src=src_p, index=idx).reshape(-1, HET_HID),
        "sparse.mm yardstick vs K8 sum", tol=1e-5)
    rows_g = msg2[src_p.long()]
    record("segment_reduce", "gigl_tpu_torch/csrc/segment_reduce.cu",
           "gigl_tpu/ops/segment.py:64", max(v["err"] for v in k8.values()),
           k8["weighted"]["ms"], k8["weighted"]["plain_ms"],
           nbytes=k8["weighted"]["nbytes"], nops=k8["weighted"]["nops"],
           library_ms=cuda_ms(lambda: torch.sparse.mm(adj, msg2)),
           library_call="torch.sparse.mm (CSR of the in-edges, fp32) = the "
           "sum mode; the weighted mode (ms, the HGT pass's) has no "
           "single-call counterpart",
           index_add_ms=cuda_ms(lambda: torch.zeros(
               (HET_PAPERS, HET_HID), device=dev).index_add_(0, dst_l,
                                                             rows_g)),
           edges=e_p, width=HET_HID, eager_ms=k8["weighted"]["eager_ms"],
           gathered_bytes=e_p * HET_HID * 4,
           modes={m_: {k_: v_ for k_, v_ in v.items()
                       if k_ not in ("nbytes", "nops")}
                  for m_, v in k8.items()})
    del q, kr, msg, msg2, logits, alpha, adj, rows_g

    # -- exact typed inference: HGT and RGCN ----------------------------------
    def make_encoder(conv):
        return HeteroGNNEncoder(
            HET_HID, HET_OUT, ("author", "paper"), edge_types,
            {"author": D, "paper": D}, conv=conv, heads=HET_HEADS,
            num_bases=HET_BASES if conv == "rgcn" else 0)

    features = {nt: torch.as_tensor(f, device=dev) for nt, f in feats.items()}
    edges_dev = {et: tuple(torch.as_tensor(a, device=dev).to(torch.int32)
                           for a in pair) for et, pair in edges_np.items()}
    counts = {}
    for conv in ("hgt", "rgcn"):
        enc = make_encoder(conv)
        init_params(enc, 0)
        sinks = {nt: Sink() for nt in num_nodes}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        _build.reset_launches()
        t0 = time.perf_counter()
        run_full_graph_inference_hetero(enc, None, graph, sinks, device=dev)
        torch.cuda.synchronize()
        entry_s = time.perf_counter() - t0
        path = f"typed_full_{conv}"
        counts[path] = dict(_build.launches)
        peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
        emit({"phase": "main_path", "path": path, "launches": counts[path],
              "seconds": entry_s})
        for k in TYPED_FULL_KERNELS[conv]:
            check(counts[path][k] > 0, f"{k} was not launched on {path}")
        got = {nt: sinks[nt].table(n, HET_OUT, path)
               for nt, n in num_nodes.items()}
        segs = TypedSegments.build(edges_dev, num_nodes,
                                   enc.convs[0].segments_by, dev,
                                   backward=False)
        before = dict(_build.launches)
        with torch.inference_mode():
            with plain_kernels():
                want = enc.encode_full(features, edges_dev, num_nodes,
                                       segments=segs)
            check(dict(_build.launches) == before,
                  "the plain typed pass launched a kernel")
            # fp32: the same sums in another order
            errs = {nt: rel_err(torch.as_tensor(got[nt]), want[nt].cpu(),
                                f"{path} {nt} vs its plain pass", tol=1e-5)
                    for nt in num_nodes}
            del want
            enc.encode_full(features, edges_dev, num_nodes, segments=segs)
            times = []
            with timed_window(path):
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    enc.encode_full(features, edges_dev, num_nodes,
                                    segments=segs)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
            encode_ms = float(np.median(times)) * 1e3
            with timed_window(path), torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(TYPED_PROFILED):
                    enc.encode_full(features, edges_dev, num_nodes,
                                    segments=segs)
                torch.cuda.synchronize()
                window_us = (time.perf_counter() - t0) * 1e6
        emit({"phase": "typed_full_graph_throughput", "model": conv,
              "max_abs_err": errs, "entry_point_s": entry_s,
              "segment_build_s": seg_s["dst" if conv == "hgt"
                                       else "relation"],
              "encode_ms": encode_ms, "encode_ms_runs": [
                  t_ * 1e3 for t_ in times],
              "nodes_per_s": n_nodes / (encode_ms / 1e3),
              "edges_per_pass": 2 * n_edges,
              "edges_per_s": 2 * n_edges / (encode_ms / 1e3),
              "peak_mem_gb": peak_gb,
              "profile": profile_summary(prof, TYPED_PROFILED, window_us,
                                         encode_ms), "card": card})
        del enc, sinks, got

    # -- the sampled typed HGT path: encode_batch over every node --------------
    paths = {nt: resolve_path(nt, [
        SamplingOp(name, et, k, () if parent is None else (parent,))
        for name, et, k, parent in ops]) for nt, ops in DBLP_PATHS.items()}
    dg = HeteroDeviceGraph.from_hetero(graph, paths, device=dev)
    for tab in (False, True):
        path = "typed_sampled_" + ("tabularized" if tab else "live")
        sinks = {nt: Sink() for nt in num_nodes}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        _build.reset_launches()
        t0 = time.perf_counter()
        trainer = HeteroNALPTrainer(
            HeteroLinkPredictionGNN(make_encoder("hgt"),
                                    LinkPredictionDecoder()), dg, paths,
            HeteroNALPTrainerConfig("paper", "author", tabularized=tab),
            device=dev)
        trainer.init_params(0)
        n_batches = 0
        for nt in ("paper", "author"):
            for ids, valid in node_batches(num_nodes[nt],
                                           InferenceConfig(batch_size=BATCH)):
                emb = trainer.encode_batch(ids, nt)
                sinks[nt].add_embeddings(ids[:valid],
                                         emb[:valid].float().cpu().numpy())
                n_batches += 1
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t0
        counts[path] = dict(_build.launches)
        peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
        emit({"phase": "main_path", "path": path, "launches": counts[path],
              "seconds": pass_s, "batches": n_batches})
        for k in TYPED_SAMPLED_KERNELS:
            check(counts[path][k] > 0, f"{k} was not launched on {path}")
        errs = {}
        before = dict(_build.launches)
        with torch.inference_mode():
            for nt, n in num_nodes.items():
                got = sinks[nt].table(n, HET_OUT, path)
                ids0 = torch.arange(BATCH, dtype=torch.int32, device=dev)
                with plain_kernels():
                    want = trainer._encode_impl(trainer.graph, ids0, nt, 0,
                                                False)
                errs[nt] = rel_err(torch.as_tensor(got[:BATCH]), want.cpu(),
                                   f"{path} {nt} batch 0 vs plain", tol=1e-5)
            check(dict(_build.launches) == before,
                  "the plain typed batches launched a kernel")
            ids_t = torch.arange(BATCH, dtype=torch.int32, device=dev)
            device_ms = cuda_ms(lambda: trainer._encode_impl(
                trainer.graph, ids_t, "paper", 0, False), reps=10)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for b_ in range(20):
                    trainer.encode_batch(np.arange(
                        b_ * BATCH, (b_ + 1) * BATCH) % HET_PAPERS, "paper")
                torch.cuda.synchronize()
                window_us = (time.perf_counter() - t0) * 1e6
        ms_batch = pass_s / n_batches * 1e3
        emit({"phase": "typed_sampled_throughput", "path": path,
              "max_abs_err_batch0": errs, "seconds": pass_s,
              "nodes_per_s": n_nodes / pass_s, "ms_per_batch": ms_batch,
              "device_ms_per_paper_batch": device_ms,
              "peak_mem_gb": peak_gb,
              "profile_20_paper_batches": profile_summary(
                  prof, 20, window_us, window_us / 20 / 1e3),
              "card": card})
        del trainer, sinks

    # -- typed training: the DBLP yaml's configuration ------------------------
    writes = EdgeType.from_str(WRITES)
    t0 = time.perf_counter()
    dg_t = HeteroDeviceGraph.from_hetero(
        graph, paths, supervision_edge_type=writes,
        supervision_edges=graph.edges[writes], supervision_anchor="dst",
        device=dev)
    torch.cuda.synchronize()
    emit({"phase": "typed_train_graph", "seconds": time.perf_counter() - t0,
          "supervision_edges": int(graph.edges[writes].shape[1])})
    tcfg = HeteroNALPTrainerConfig(
        "paper", "author", num_positives=1, num_hard_negs=0,
        num_random_negs=R, loss_type="retrieval", temperature=0.07)
    n_anchor = TT_WARMUP + TT_STEPS + TT_PROFILED + 1
    anchors_t = (np.arange(BATCH * n_anchor) % HET_PAPERS).astype(
        np.int32).reshape(n_anchor, BATCH)
    # forward-aggregated edges per step, as bench.py:631-638 counts them
    # over a fanout tree: an op's slots are aggregated once by each layer
    # that updates its parent entry (L - depth + 1 of the L = 2 layers)
    per_root = {}
    for nt, spec in paths.items():
        slots = []
        for op in spec:
            slots.append(op.fanout * (1 if op.parent < 0
                                      else slots[op.parent]))
        per_root[nt] = sum(k * max(0, 3 - op.depth)
                           for k, op in zip(slots, spec))
    edges_step = per_root["paper"] * BATCH + per_root["author"] * (
        BATCH * tcfg.num_positives + R)
    # HGT's last update of the candidates (authors) adds one bias to every
    # candidate's embedding: each anchor's scores all move by the same
    # amount, and the retrieval loss leaves that bias no gradient
    symmetric = {"hgt": ("encoder.convs.1.a_author.bias",), "rgcn": ()}
    for conv in ("hgt", "rgcn"):
        path = f"typed_train_{conv}"
        trainer = HeteroNALPTrainer(
            HeteroLinkPredictionGNN(make_encoder(conv),
                                    LinkPredictionDecoder()), dg_t, paths,
            tcfg, optimizer_args={"learning_rate": "1e-3"}, device=dev)
        state = trainer.init_state(0)
        # the batch is drawn inside the loss, so the plain step draws it
        # through the twins too
        vs = step_vs_plain(trainer.model, lambda: trainer.loss(
            trainer.sample_batch(anchors_t[-1], 0)), _build.launches,
            gated=False, symmetric=symmetric[conv])
        emit({"phase": "typed_train_step_vs_plain", "model": conv, **vs})
        # fp32: the same sums in another order
        check(vs["loss_rel_err"] <= 1e-5,
              f"{path}: loss differs from the plain step: {vs}")
        check(vs["max_grad_err_rel_to_scale"] <= 1e-4,
              f"{path}: a gradient differs from the plain step: {vs}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        _build.reset_launches()
        gen_t = torch.Generator(device=dev).manual_seed(1)
        state, warm = trainer.train_steps(state, anchors_t[:TT_WARMUP], gen_t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, losses = trainer.train_steps(
            state, anchors_t[TT_WARMUP:TT_WARMUP + TT_STEPS], gen_t)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / TT_STEPS
        counts[path] = dict(_build.launches)
        peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
        emit({"phase": "main_path", "path": path, "launches": counts[path],
              "steps": TT_WARMUP + TT_STEPS})
        for k in TYPED_TRAIN_KERNELS[conv]:
            check(counts[path][k] > 0, f"{k} was not launched on {path}")
        losses = losses.cpu().numpy()
        check(np.isfinite(losses).all() and np.isfinite(warm.cpu().numpy())
              .all(), f"{path}: loss not finite")
        first, last = float(losses[:10].mean()), float(losses[-10:].mean())
        check(last < first, f"{path}: loss did not fall: {first} -> {last}")
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = trainer.train_steps(
                state, anchors_t[TT_WARMUP + TT_STEPS:-1], gen_t)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        metrics = trainer.evaluate(list(anchors_t[:TT_EVAL_BATCHES]),
                                   step=state.step)
        check(0.0 <= metrics["mrr"] <= 1.0, f"{path}: MRR {metrics}")
        emit({"phase": "typed_train_throughput", "model": conv,
              "steps": TT_STEPS, "ms_per_step": step_s * 1e3,
              "edges_per_step": edges_step,
              "edges_per_s": edges_step / step_s,
              "loss_first10": first, "loss_last10": last,
              "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
              "peak_mem_gb": peak_gb, "evaluate_4_batches": metrics,
              "profile": profile_summary(prof, TT_PROFILED, window_us,
                                         step_s * 1e3), "card": card})
        del trainer, state
    return counts, {"graph": graph, "paths": paths,
                    "make_encoder": make_encoder, "anchors": anchors_t}


def coo_phases(dev, card, graph, record, rel_err, unique,
               run_path):
    """Phase 9 (see the module docstring): full-batch training over the
    COO segment ops — the two SegmentIndexes, the backward kernels K8b,
    K9b, K10b at layer 2's shapes, then per model a step against its plain
    recomputation and the path itself. Returns {path: (launch counts,
    steps)} and {model: ms per step}."""
    from gigl_tpu_torch.models.encoders import GNNEncoder
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.ops.segment import (
        SegmentIndex, _sddmm_bwd_coef_plain, _sddmm_plain,
        _segment_reduce_bwd_plain, _segment_reduce_plain,
        _segment_softmax_bwd_plain, _segment_softmax_plain, sddmm,
        sddmm_bwd_coef, segment_reduce_bwd, segment_softmax,
        segment_softmax_bwd)
    from gigl_tpu_torch.training.full_batch import (
        FullBatchTrainer, full_batch_data_from_graph)

    coo = graph.edges[graph.metadata.edge_types[0]]
    build_s = {}
    for side, ids in (("dst", coo[1]), ("src", coo[0])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        SegmentIndex.from_ids(ids, N, dev)
        torch.cuda.synchronize()
        build_s[side] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fb = full_batch_data_from_graph(graph, build_ell=False, device=dev)
    torch.cuda.synchronize()
    fb_s = time.perf_counter() - t0
    idx, sidx, src, dst = fb.index, fb.src_index, fb.src, fb.dst
    emit({"phase": "full_batch_data", "path": "coo", "seconds": fb_s,
          "index_build_s": build_s, "edges": idx.num_edges,
          "max_in_degree": int((idx.ptr[1:] - idx.ptr[:-1]).max()),
          "max_out_degree": int((sidx.ptr[1:] - sidx.ptr[:-1]).max())})
    check(fb.ell is None and idx.num_edges == E, "the COO data is not the "
          "graph's edges")
    dst_l, src_l = dst.long(), src.long()
    gen = torch.Generator(device=dev).manual_seed(10)

    # K8b over the whole source walk, layer 2's [100k, 256] fp32 cotangent,
    # against autograd through K8's plain twin, in its composed mode (the
    # segment ids are fb.dst, which the source index was built from: ms)
    # and its chained mode (a copy: chained_ms), bit-equal. bytes, as the
    # composed mode reads: the cotangent, the source index's pointers and
    # gathered destinations and the output once (weighted: + its order and
    # the [E, 4] fp32 weights; mean: + the dst pointers; max: + the forward
    # rows and the dst index, read by the tie pass); ops: an add (and a
    # multiply) per edge and value. gathered_bytes: the cotangent rows the
    # walk reads, one an edge.
    g8 = torch.randn((N, HID), generator=gen, device=dev)
    w8 = torch.rand((E, GAT_HEADS), generator=gen, device=dev)
    x8 = (torch.randn((N, HID), generator=gen, device=dev) * 2).round()
    base8 = N * HID * 4 * 2 + E * 4 + (N + 1) * 4
    # the yardstick: torch.sparse.mm of the source-sorted CSR (row r's
    # columns the destinations of the edges that read r, in walk order;
    # values 1, or 1 / count for the mean), built here, not timed
    col8 = dst_l[sidx.order.long()]
    cnt = (idx.ptr[1:] - idx.ptr[:-1]).float().clamp(min=1.0)
    csr8 = {op: torch.sparse_csr_tensor(
        sidx.ptr.long(), col8, vals, (N, N)) for op, vals in (
            ("sum", torch.ones(E, device=dev)), ("mean", 1.0 / cnt[col8]))}
    dst_copy = dst.clone()   # the same ids in another tensor: chained mode
    k8b = {}
    for mode, op, w in (("sum", "sum", None), ("mean", "mean", None),
                        ("max", "max", None), ("weighted", "sum", w8)):
        xin = x8 if op == "max" else None

        def k8b_kernel(op=op, w=w, xin=xin, ids=dst):
            return segment_reduce_bwd(g8, ids, N, op=op, src=src, weight=w,
                                      x=xin, index=idx, src_index=sidx)

        def k8b_chained(op=op, w=w, xin=xin):
            return k8b_kernel(op, w, xin, dst_copy)

        def k8b_plain(op=op, w=w, xin=xin):
            return _segment_reduce_bwd_plain(g8, dst, N, op, src, w, xin)

        xx = x8.clone().requires_grad_()
        _segment_reduce_plain(xx, dst, N, op, src, w).backward(g8)
        got = k8_modes_checked(k8b_kernel, k8b_chained, f"K8b {mode}",
                               "segment_reduce_bwd")
        err = rel_err(got, xx.grad, f"K8b {mode}", tol=1e-5)
        nbytes = base8 + {"sum": 0, "mean": (N + 1) * 4,
                          "max": N * HID * 4 + E * 4 + (N + 1) * 4,
                          "weighted": E * 4 + E * GAT_HEADS * 4}[mode]
        k8b[mode] = {"err": err, "ms": cuda_ms(k8b_kernel),
                     "chained_ms": cuda_ms(k8b_chained),
                     "plain_ms": cuda_ms(k8b_plain, reps=3),
                     "eager_ms": eager_ms(k8b_kernel),
                     "bound_ms": bound_ms(nbytes, E * HID * (
                         2 if w is not None else 1))[0], "nbytes": nbytes,
                     "gathered_bytes": E * HID * 4}
        if mode in csr8:
            def k8b_sparse(mode=mode):
                return torch.sparse.mm(csr8[mode], g8)

            rel_err(k8b_sparse(), got, f"sparse.mm yardstick vs K8b {mode}",
                    tol=1e-5)
            k8b[mode]["library_ms"] = cuda_ms(k8b_sparse)
        del xx, got
    rows8 = g8[dst_l] / cnt[dst_l][:, None]     # gathered beforehand

    def k8b_index_add():
        return torch.zeros((N, HID), device=dev).index_add_(0, src_l, rows8)

    rel_err(k8b_index_add(), segment_reduce_bwd(
        g8, dst, N, op="mean", src=src, index=idx, src_index=sidx),
        "index_add_ yardstick vs K8b mean", tol=1e-5)
    record("segment_reduce_bwd", "gigl_tpu_torch/csrc/segment_reduce_bwd.cu",
           "gigl_tpu/ops/segment.py:20", max(v["err"] for v in k8b.values()),
           k8b["mean"]["ms"], k8b["mean"]["plain_ms"],
           nbytes=k8b["mean"]["nbytes"], nops=E * HID,
           library_ms=k8b["mean"]["library_ms"],
           library_call="torch.sparse.mm of the source-sorted CSR (values "
                        "1 / count) and the [N, 256] cotangent = the mean "
                        "mode; sum: values 1 (modes.sum.library_ms)",
           index_add_ms=cuda_ms(k8b_index_add),
           index_add_call="torch.Tensor.index_add_ of the cotangent rows "
                          "gathered by dst and divided by the count "
                          "(atomics; gather and division not timed)",
           table=[N, HID], dtype="float32", edges=E,
           eager_ms=k8b["mean"]["eager_ms"],
           modes={m_: {k_: v_ for k_, v_ in v.items() if k_ != "nbytes"}
                  for m_, v in k8b.items()})
    del g8, w8, x8, rows8, csr8, col8

    # K9b at [2M, 4]: alpha from K9, a random cotangent. fp32 against
    # autograd through K9's plain twin (2e-5); bf16 (alpha from bf16
    # logits) against K9b's plain twin (one rounding: 2**-8 of the scale).
    # bytes: alpha and g read, dlogits written, the index; ops: a
    # multiply-add for the sum, a subtract and a multiply. gathered_bytes:
    # the 32-byte sectors a walk in random edge order touches, one a slot
    # for each of alpha, g and dlogits.
    k9b = {}
    for mode, dtype in (("coo_fp32", torch.float32),
                        ("coo_bf16", torch.bfloat16)):
        lg9 = (torch.randn((E, GAT_HEADS), generator=gen, device=dev)
               * 3).to(dtype)
        alpha9 = segment_softmax(lg9, dst, N, index=idx)
        g9 = torch.randn((E, GAT_HEADS), generator=gen, device=dev).to(dtype)

        def k9b_kernel(alpha9=alpha9, g9=g9):
            return segment_softmax_bwd(alpha9, g9, dst, N, index=idx)

        def k9b_plain(alpha9=alpha9, g9=g9):
            return _segment_softmax_bwd_plain(alpha9, g9, dst, N)

        got9 = k9b_kernel()
        check(torch.equal(got9, k9b_kernel()),
              f"K9b {mode}: a repeat run differs")
        if dtype == torch.float32:
            lt = lg9.clone().requires_grad_()
            _segment_softmax_plain(lt, dst, N).backward(g9)
            err9 = rel_err(got9, lt.grad, f"K9b {mode}", tol=2e-5)
            del lt
        else:
            err9 = rel_err(got9, k9b_plain(), f"K9b {mode}", tol=2.0 ** -8)
        esize = lg9.element_size()
        b9, by9 = bound_ms(E * GAT_HEADS * esize * 3 + E * 4 + (N + 1) * 4,
                           E * GAT_HEADS * 4)
        k9b[mode] = {"err": err9, "ms": cuda_ms(k9b_kernel),
                     "plain_ms": cuda_ms(k9b_plain, reps=3),
                     "eager_ms": eager_ms(k9b_kernel), "bound_ms": b9,
                     "bound_by": by9, "gathered_bytes": 3 * E * 32,
                     "edges": E, "heads": GAT_HEADS,
                     "dtype": str(dtype).split(".")[-1]}
        if dtype == torch.float32:
            def k9b_library(alpha9=alpha9, g9=g9):
                ag = alpha9 * g9
                return alpha9 * (g9 - torch.zeros(
                    (N, GAT_HEADS), device=dev).index_add_(0, dst_l, ag)[
                        dst_l])

            rel_err(k9b_library(), got9, "torch composition vs K9b",
                    tol=2e-5)
            k9b[mode]["library_ms"] = cuda_ms(k9b_library)
        del lg9, alpha9, g9, got9
    main9 = k9b["coo_fp32"]
    record("segment_softmax_bwd",
           "gigl_tpu_torch/csrc/segment_softmax_bwd.cu",
           "gigl_tpu/ops/segment.py:51", main9["err"], main9["ms"],
           main9["plain_ms"],
           nbytes=E * GAT_HEADS * 4 * 3 + E * 4 + (N + 1) * 4,
           nops=E * GAT_HEADS * 4, library_ms=main9["library_ms"],
           library_call="alpha * (g - index_add_(alpha * g)[dst]) in "
                        "PyTorch (one multiply, one index_add_, a gather, "
                        "a subtract and a multiply)",
           edges=E, heads=GAT_HEADS, eager_ms=main9["eager_ms"],
           gathered_bytes=main9["gathered_bytes"], modes=k9b)

    # K10b at the COO Transformer step's [2M, 4]: the path's mode (the
    # coefficients alone: the step's scale is a constant) in fp32 and with
    # a bf16 g, and the mode with the scale's cotangent (raw: the unscaled
    # scores of layer 2's 4 heads of 64), each one CUDA launch; then the
    # whole sddmm backward (K10 unscaled, K10b, K8 for dq, K8b for dk)
    # against autograd through K10's plain twin. bytes: g (and raw) read,
    # coef written; ops: a multiply per (edge, head), and a multiply-add
    # more for the cotangent. Yardsticks: torch.mul(g, scale) and
    # torch.linalg.vecdot(g, raw, dim=0).
    q10, k10 = (torch.randn((N, GAT_HEADS, HID // GAT_HEADS), generator=gen,
                            device=dev) for _ in range(2))
    sc10 = torch.full((GAT_HEADS,), (HID // GAT_HEADS) ** -0.5, device=dev)
    g10 = torch.randn((E, GAT_HEADS), generator=gen, device=dev)
    raw10 = sddmm(src, dst, q10, k10, index=idx)
    k10b_modes = {}
    for mode, g_, raw_ in (("coef_fp32", g10, None),
                           ("coef_bf16", g10.bfloat16(), None),
                           ("dscale_fp32", g10, raw10)):
        def k10b_kernel(g_=g_, raw_=raw_):
            return sddmm_bwd_coef(g_, sc10, raw_)

        def k10b_plain(g_=g_, raw_=raw_):
            return _sddmm_bwd_coef_plain(g_, sc10, raw_)

        (coef_, ds_), (want_c, want_d) = k10b_kernel(), k10b_plain()
        check(torch.equal(coef_, want_c),
              f"K10b {mode}: coef is not the twin's single multiply")
        again = k10b_kernel()
        check(torch.equal(coef_, again[0]) and (ds_ is None or torch.equal(
            ds_, again[1])), f"K10b {mode}: a repeat run differs")
        val_bytes = E * GAT_HEADS * g_.element_size()
        nbytes = val_bytes + E * GAT_HEADS * 4 + GAT_HEADS * 4
        nops = E * GAT_HEADS
        entry = {"bit_equal_coef": True, "dtype": str(g_.dtype).split(".")[-1]}
        def library(g_=g_, raw_=raw_):
            return (torch.mul(g_, sc10) if raw_ is None
                    else torch.linalg.vecdot(g_, raw_, dim=0))

        if raw_ is not None:
            # within 1e-6 of sum_e |g raw| per head of an fp64 sum: the sum
            # of 2M signed terms nearly cancels, so an error relative to
            # the result itself would mean nothing
            prod = g_.double() * raw_.double()
            abs_sum = prod.abs().sum(0)
            rel = float(((ds_.double() - prod.sum(0)).abs() / abs_sum).max())
            check(rel <= 1e-6, f"K10b dscale {rel} of sum |g raw| from an "
                  "fp64 sum (limit 1e-6)")
            entry.update(dscale_err_rel_to_abs_sum=rel,
                         twin_dscale_err_rel_to_abs_sum=float((
                             (want_d.double() - prod.sum(0)).abs()
                             / abs_sum).max()))
            del prod, abs_sum
            nbytes += val_bytes
            nops += E * GAT_HEADS
        b_, _ = bound_ms(nbytes, nops)
        entry.update(ms=cuda_ms(k10b_kernel), plain_ms=cuda_ms(k10b_plain,
                                                               reps=3),
                     bound_ms=b_, library_ms=cuda_ms(library),
                     eager_ms=eager_ms(k10b_kernel),
                     cuda_launches=device_launches(k10b_kernel, "sddmm_bwd"))
        check(entry["cuda_launches"] == 1,
              f"K10b {mode}: {entry['cuda_launches']} CUDA launches, not 1")
        k10b_modes[mode] = entry
        del coef_, ds_, want_c, want_d, again

    def full_bwd(fn):
        leaves = [t.clone().requires_grad_() for t in (q10, k10, sc10)]
        fn(*leaves).backward(g10)
        return [t_.grad for t_ in leaves]

    def kernel_bwd():
        return full_bwd(lambda q_, k_, s_: sddmm(
            src, dst, q_, k_, scale=s_, index=idx, src_index=sidx))

    got10, want10 = kernel_bwd(), full_bwd(
        lambda q_, k_, s_: _sddmm_plain(src, dst, q_, k_, s_))
    # max_abs_err below is coef's, bit-equal to the twin (0.0); this is
    # the whole backward's largest absolute error (dq, dk, dscale), each
    # held within 1e-5 of its scale
    whole_err = max(rel_err(a, b, f"sddmm backward {n_}", tol=1e-5)
                    for n_, a, b in zip(("dq", "dk", "dscale"), got10,
                                        want10))
    check(all(torch.equal(a, b) for a, b in zip(got10, kernel_bwd())),
          "the sddmm backward: a repeat run differs")
    main10 = k10b_modes["coef_fp32"]
    record("sddmm_bwd", "gigl_tpu_torch/csrc/sddmm_bwd.cu",
           "gigl_tpu/ops/segment.py:90", 0.0, main10["ms"],
           main10["plain_ms"],
           nbytes=E * GAT_HEADS * 4 * 2 + GAT_HEADS * 4,
           nops=E * GAT_HEADS, library_ms=main10["library_ms"],
           library_call="torch.mul(g, scale) (the coefficients); the "
                        "scale's cotangent mode: torch.linalg.vecdot(g, "
                        "raw, dim=0)",
           edges=E, heads=GAT_HEADS, eager_ms=main10["eager_ms"],
           cuda_launches=main10["cuda_launches"], modes=k10b_modes,
           whole_backward_err=whole_err,
           whole_backward_eager_ms=eager_ms(kernel_bwd, reps=10),
           whole_backward_plain_eager_ms=eager_ms(lambda: full_bwd(
               lambda q_, k_, s_: _sddmm_plain(src, dst, q_, k_, s_)),
               reps=3))
    del q10, k10, g10, raw10, got10, want10
    walk = segment_walk_rows(dev, fb, rel_err, unique)

    counts, ms = {}, {}
    for model_name, kw in (("graphsage", None),
                           ("gat", {"heads": GAT_HEADS}),
                           ("transformer", {"heads": GAT_HEADS})):
        path = f"coo_full_batch_{model_name}"
        fbt = FullBatchTrainer(
            GNNEncoder(D, HID, C, num_layers=2, conv=model_name,
                       conv_kwargs=kw), fb,
            optimizer_args={"learning_rate": "1e-2"}, device=dev)
        state = fbt.init_state(0)
        # the Transformer's key bias shifts all of a destination's logits
        # alike, so the softmax leaves it no gradient
        vs = step_vs_plain(fbt.encoder, fbt.loss, _build.launches,
                           symmetric=tuple(
                               f"convs.{i}.lin_k.bias" for i in range(2)
                               if model_name == "transformer"))
        emit({"phase": "coo_full_batch_step_vs_plain", "model": model_name,
              **vs})
        # fp32: the same sums in another order
        check(vs["loss_rel_err"] <= 1e-5,
              f"{path}: loss differs from the plain step: {vs}")
        check(vs["max_grad_err_rel_to_scale"] <= 1e-4,
              f"{path}: a gradient differs from the plain step: {vs}")
        cnt_, nsteps, row = run_path(path, fbt, state, FB_STEPS, FB_WARMUP,
                                     FB_PROFILED, COO_KERNELS[model_name])
        counts[path] = (cnt_, nsteps)
        if model_name == "graphsage":
            # layer 2's aggregate only: layer 1's input needs no gradient
            check(cnt_["segment_reduce_bwd"] == nsteps,
                  f"K8b launched {cnt_['segment_reduce_bwd']} times in "
                  f"{nsteps} steps, not once per step (layer 2 only)")
        step_s = row["ms_per_step"] / 1e3
        ms[model_name] = row["ms_per_step"]
        emit({"phase": "coo_full_batch_train_throughput", "model": model_name,
              "edges_per_step": 2 * E, "edges_per_s": 2 * E / step_s,
              "nodes_per_s": N / step_s, **row})
        del fbt, state
    return counts, ms, walk


@contextlib.contextmanager
def edge_gate_flips(ell, mode, slope=0.2):
    """Record what K11 (or its twin) is given in the kernel step and in the
    plain one, and yield an ``explain`` for ``step_vs_plain``. An edge's
    gradient is one term of its entry — no sum dilutes it — so where the
    two forwards' fp32 rounding puts a gate on the two sides of 0, that
    edge's gradient row differs by a whole term: GINE's relu of ``x[src] +
    e`` (recomputed from the recorded layer inputs), EdgeAttrGAT's
    leaky_relu derivative of the logit's pre-activation (an entry whose K7b
    coefficient is the plain one times the slope or its inverse: every
    entry whose two coefficients differ by more than 1e-3 of the layer's
    largest must be one, and one whose differ by more than fp32 noise, 1e-5
    of it, is one when its ratio is the slope's). A gate
    that flips in one layer also moves the cotangent of its entry's source
    row (for attention, its destination's too) in the layer below, hence
    that layer's rows of the edges into those nodes. ``explain`` marks the
    edges with such a gate and, layer by layer downwards, the edges into
    the nodes those moved; it checks that the flipped gates are few (at
    most FLIPS_MAX or one per million) and, for GINE, each within
    FLIP_NEAR_ZERO of its layer's scale from 0."""
    from gigl_tpu_torch.ops import attention, ell as ell_mod, ell_aggregate

    recs = []
    holder = ell_aggregate if mode == "gine" else attention
    orig_k, orig_p = holder.ell_edge_grad, ell_mod._ell_edge_grad_plain

    def rec_k(g, ell_, mode_, **kw):
        recs.append({k: v.detach().clone() for k, v in kw.items()
                     if isinstance(v, torch.Tensor)})
        return orig_k(g, ell_, mode_, **kw)

    def rec_p(g, ell_, mode_, x=None, ea=None, alpha=None, coef=None,
              *args):
        recs.append({k: v.detach().clone() for k, v in (
            ("x", x), ("ea", ea), ("alpha", alpha), ("coef", coef))
            if v is not None})
        return orig_p(g, ell_, mode_, x, ea, alpha, coef, *args)

    def explain(name, gk, gp, scale):
        half = len(recs) // 2
        check(len(recs) == 2 * half > 0, f"{name}: K11 saw {len(recs)} "
              "calls, not one per layer in each step")
        pos = ell.edge_pos.long()
        src, dst = ell.ent_src.long()[pos], ell.ent_row.long()[pos]
        flipped = torch.zeros(gk.shape[0], dtype=torch.bool, device=gk.device)
        moved = torch.zeros(ell.num_nodes, dtype=torch.bool,
                            device=gk.device)  # sources whose cotangent moved
        n_flip, n_gates, near = 0, 0, 0.0
        # attention: entries whose coefficients differ by more than fp32
        # noise (1e-5 of the layer's largest) but less than 1e-3 of it, by
        # the slope's ratio (a flipped gate of a smaller coefficient) or not
        n_small_ratio, n_small_other = 0, 0
        # the backward calls K11 from the last layer down
        for rk, rp in zip(recs[:half], recs[half:]):
            here = moved[dst]
            if mode == "gine":
                zk, zp = rk["x"][src] + rk["ea"], rp["x"][src] + rp["ea"]
                fl = (zk > 0) != (zp > 0)
                if bool(fl.any()):
                    near = max(near, float(zk[fl].abs().max()
                                           / zk.abs().max()))
                here |= fl.any(1)
            else:
                ck, cp = rk["coef"], rp["coef"]
                off = (ck - cp).abs() > 1e-3 * cp.abs().max()
                ratio = ck[off] / cp[off]
                check(bool(((ratio - slope).abs() <= 1e-2 * slope).logical_or(
                    (ratio - 1 / slope).abs() <= 1e-2 / slope).all()),
                      f"{name}: K7b coefficients differ from the plain step "
                      "by other than a leaky_relu slope")
                small = ((ck - cp).abs() > 1e-5 * cp.abs().max()) & ~off
                rs = ck[small] / cp[small]
                is_ratio = ((rs - slope).abs() <= 1e-2 * slope) | (
                    (rs - 1 / slope).abs() <= 1e-2 / slope)
                n_small_ratio += int(is_ratio.sum())
                n_small_other += int((~is_ratio).sum())
                flips = off.clone()
                flips[small] = is_ratio
                fl = flips & ell.ent_mask[:, None]
                here |= fl.any(1)[pos]
            flipped |= here
            moved[src[here]] = True
            if mode != "gine":      # the query's cotangent moves too
                moved[dst[here]] = True
            n_flip += int(fl.sum())
            n_gates += fl.numel()
        rows = (gk - gp).abs().amax(1) > 1e-4 * scale
        check(n_flip <= max(FLIPS_MAX, n_gates // 10**6),
              f"{name}: {n_flip} of {n_gates} gates flipped")
        check(near <= FLIP_NEAR_ZERO, f"{name}: a flipped GINE gate's sum "
              f"is {near} of its layer's scale from 0")
        return rows & flipped, {
            "rows_over_1e-4": int(rows.sum()),
            "rows_with_a_flipped_gate": int(flipped.sum()),
            "unexplained_rows": int((rows & ~flipped).sum()),
            "small_slope_ratio_entries": n_small_ratio,
            "small_other_entries": n_small_other,
            "gates": n_gates, "gates_flipped": n_flip,
            "gine_flipped_sum_rel_to_scale": near}

    holder.ell_edge_grad, ell_mod._ell_edge_grad_plain = rec_k, rec_p
    try:
        yield explain
    finally:
        holder.ell_edge_grad = orig_k
        ell_mod._ell_edge_grad_plain = orig_p


# What the COO edge convs' gates see, layer by layer, while a
# coo_edge_gate_flips context is open: GINE's (x, edge rows), EdgeAttrGAT's
# logit pre-activations; None otherwise.
COO_GATES = None


def coo_gate_record(*tensors):
    if COO_GATES is not None:
        COO_GATES.append(tuple(t.detach().clone() for t in tensors))


@contextlib.contextmanager
def coo_edge_gate_flips(walk, mode, slope=0.2):
    """``edge_gate_flips`` for the COO path (phase 17): records each edge
    conv's gate inputs in the kernel step (a wrapper of the conv's op) and
    in the plain one (the plain versions of ``plain_kernels``), and yields
    an ``explain`` for ``step_vs_plain`` over the raw edge table (COO
    order; the layers ran over ``walk``'s graph). A gate on the two sides
    of 0 in the two steps — GINE's relu of ``x[src] + e``, EdgeAttrGAT's
    leaky_relu of the logit's pre-activation — changes that edge's row by
    a whole term, and, in the layer below, the rows of the edges into the
    nodes whose cotangent it moved (the source; for attention the
    destination too). ``explain`` marks those edges, checks that the
    flipped gates are few (at most FLIPS_MAX or one per million) and each
    within FLIP_NEAR_ZERO of its layer's scale from 0."""
    global COO_GATES
    from gigl_tpu_torch.models import convs

    name = "coo_spmm" if mode == "gine" else "coo_gat_edges"
    orig = getattr(convs, name)

    def rec_coo(src, dst, x, n, **kw):
        if kw.get("edge_rows") is not None and kw.get("edge_mode") == "gine":
            coo_gate_record(x, kw["edge_rows"])
        return orig(src, dst, x, n, **kw)

    def rec_gat(src, dst, n, hs, he, pre, att_src, **kw):
        e, (_, h, dh) = src.shape[0], hs.shape
        coo_gate_record(pre + (he.reshape(e, h, dh)
                               * att_src.to(he.dtype)).sum(-1))
        return orig(src, dst, n, hs, he, pre, att_src, **kw)

    ws, wd = walk.src.long(), walk.dst.long()
    rank = walk.rank.long()

    def explain(what, gk, gp, scale):
        half = len(COO_GATES) // 2
        check(len(COO_GATES) == 2 * half > 0, f"{what}: the edge convs "
              f"recorded {len(COO_GATES)} gate inputs, not one a layer in "
              "each step")
        flipped = torch.zeros(ws.shape[0], dtype=torch.bool,
                              device=gk.device)          # walk slots
        moved = torch.zeros(int(max(ws.max(), wd.max())) + 1,
                            dtype=torch.bool, device=gk.device)
        n_flip, n_gates, near = 0, 0, 0.0
        for rk, rp in reversed(list(zip(COO_GATES[:half],
                                        COO_GATES[half:]))):
            if mode == "gine":
                zk, zp = rk[0][ws] + rk[1], rp[0][ws] + rp[1]
                fl = (zk > 0) != (zp > 0)
            else:
                zk, zp = rk[0], rp[0]
                fl = (zk >= 0) != (zp >= 0)
            if bool(fl.any()):
                near = max(near, float(zk[fl].abs().max() / zk.abs().max()))
            here = moved[wd] | fl.reshape(fl.shape[0], -1).any(1)
            flipped |= here
            moved[ws[here]] = True
            if mode != "gine":      # the query's cotangent moves too
                moved[wd[here]] = True
            n_flip += int(fl.sum())
            n_gates += fl.numel()
        rows = (gk - gp).abs().amax(1) > 1e-4 * scale
        flipped = flipped[rank]                          # COO order
        check(n_flip <= max(FLIPS_MAX, n_gates // 10**6),
              f"{what}: {n_flip} of {n_gates} gates flipped")
        check(near <= FLIP_NEAR_ZERO, f"{what}: a flipped gate's input is "
              f"{near} of its layer's scale from 0")
        return rows & flipped, {
            "rows_over_1e-4": int(rows.sum()),
            "rows_with_a_flipped_gate": int(flipped.sum()),
            "unexplained_rows": int((rows & ~flipped).sum()),
            "gates": n_gates, "gates_flipped": n_flip,
            "flipped_gate_input_rel_to_scale": near}

    COO_GATES = []
    setattr(convs, name, rec_coo if mode == "gine" else rec_gat)
    try:
        yield explain
    finally:
        setattr(convs, name, orig)
        COO_GATES = None


# GATv2's leaky gates of the kernel step, replayed by the plain step while
# a gatv2_gate_replay context is open; None otherwise.
GATV2_GATES = None


@contextlib.contextmanager
def gatv2_gate_replay():
    """The ReLU replay of ``step_vs_plain`` for GATv2's leaky_relu of
    ``hs[src] + hd[dst]`` (phase 17; with edge rows ``(hs[src] + he) +
    hd[dst]``, phases 11 and 17, over the COO edges or the ELL graph's
    valid entries): the kernel step's gates (recorded from the same fp32
    sum K10 and K7 take) are the plain step's, so that a
    pre-activation on the two sides of 0 in the two forwards does not move
    a whole term of d hs, d hd and d att (their sums cancel over each
    destination's softmax, so one term is large beside them). Yields a
    report; the flipped gates must be few (at most FLIPS_MAX or one per
    million) and each within FLIP_NEAR_ZERO of its layer's scale from 0."""
    global GATV2_GATES
    from gigl_tpu_torch.models import convs

    orig = convs.gatv2_scores
    orig_edges, orig_ell = convs.coo_gatv2_edges, convs.fanout_attention_ell

    def rec(src, dst, hs, hd, att, **kw):
        with torch.no_grad():
            GATV2_GATES["masks"].append(
                hs.float()[src.long()] + hd.float()[dst.long()] >= 0)
        return orig(src, dst, hs, hd, att, **kw)

    # GATv2 with edge rows: the gate of (hs[src] + he) + hd[dst], the fp32
    # sum K10 and K7 take, per edge (COO) or per valid entry (ELL)
    def rec_edges(src, dst, hs, hd, he, att, **kw):
        with torch.no_grad():
            GATV2_GATES["masks"].append(gatv2_edge_z(
                src, dst, hs, hd, he.reshape(src.shape[0], *hs.shape[1:]))
                >= 0)
        return orig_edges(src, dst, hs, hd, he, att, **kw)

    def rec_ell(xd, ks, vs, ell_, mode, heads, *args, he=None, **kw):
        if mode == "gatv2" and he is not None:
            src_, dst_, eid = ell_entries(ell_)
            dh_ = xd.shape[1] // heads
            with torch.no_grad():
                GATV2_GATES["masks"].append(gatv2_edge_z(
                    src_, dst_, ks.reshape(-1, heads, dh_),
                    xd.reshape(-1, heads, dh_),
                    he[eid].reshape(-1, heads, dh_)) >= 0)
        return orig_ell(xd, ks, vs, ell_, mode, heads, *args, he=he, **kw)

    def report():
        st = {k: GATV2_GATES[k] for k in ("flips", "gates", "near")}
        check(GATV2_GATES["i"] == len(GATV2_GATES["masks"]) > 0,
              "GATv2's plain step replayed no gates")
        check(st["flips"] <= max(FLIPS_MAX, st["gates"] // 10**6),
              f"GATv2: {st['flips']} of {st['gates']} leaky gates flipped")
        check(st["near"] <= FLIP_NEAR_ZERO, f"GATv2: a flipped leaky gate's "
              f"pre-activation is {st['near']} of its layer's scale from 0")
        return {"leaky_gates": st["gates"],
                "leaky_gates_flipped_in_plain_forward": st["flips"],
                "flipped_leaky_preactivation_rel_to_scale": st["near"]}

    GATV2_GATES = {"masks": [], "i": 0, "flips": 0, "gates": 0, "near": 0.0}
    convs.gatv2_scores = rec
    convs.coo_gatv2_edges, convs.fanout_attention_ell = rec_edges, rec_ell
    try:
        yield report
    finally:
        convs.gatv2_scores = orig
        convs.coo_gatv2_edges, convs.fanout_attention_ell = (orig_edges,
                                                             orig_ell)
        GATV2_GATES = None


def ell_entries(ell):
    """The valid entries of an EllGraph as COO edges: (source row,
    destination row, edge id), int64, in flat entry order."""
    valid = ell.ent_mask
    return (ell.ent_src[valid].long(), ell.ent_row[valid].long(),
            ell.ent_edge[valid].long())


def gatv2_edge_z(src, dst, hs, hd, he3):
    """GATv2's pre-activation with edge rows, (hs[src] + he) + hd[dst]
    in fp32 [E, H, Dh]: the sum the kernels take."""
    return (hs.float()[src.long()] + he3.float()) + hd.float()[dst.long()]


def gatv2_edges_plain(src, dst, n, hs, hd, he3, att, slope):
    """GATv2 with edge rows over edges, in PyTorch: softmax over each
    destination of att . leaky((hs[src] + he) + hd[dst]), the sum of alpha
    * (hs[src] + he) -> [n, H, Dh] in hd's type. Under gatv2_gate_replay
    the leaky's gates are the kernel step's."""
    from gigl_tpu_torch.ops import segment

    k = hs.float()[src.long()] + he3.float()
    z = k + hd.float()[dst.long()]
    if GATV2_GATES is None:
        m = z >= 0
    else:
        m = GATV2_GATES["masks"][GATV2_GATES["i"]]
        GATV2_GATES["i"] += 1
        flip = (z >= 0) != m
        GATV2_GATES["flips"] += int(flip.sum())
        GATV2_GATES["gates"] += m.numel()
        if bool(flip.any()):
            GATV2_GATES["near"] = max(GATV2_GATES["near"], float(
                z[flip].abs().max() / z.abs().max()))
    logits = (torch.where(m, z, slope * z) * att.float().reshape(
        z.shape[1:])).sum(-1)
    alpha = segment._segment_softmax_plain(logits, dst, n)
    out = torch.zeros((n,) + tuple(k.shape[1:]), device=k.device).index_add(
        0, dst.long(), alpha[..., None] * k)
    return out.to(hd.dtype)


def simple_hgn_bias_timing(loss_fn, add_mode, rel_err, gen):
    """K7 and K7b in their GAT mode with SimpleHGN's per-slot relation bias,
    alone, at the largest dense block of one SimpleHGN training step
    (recorded from the step's own K7 calls: its inputs, masks and bias),
    against their plain versions, beside their byte bounds; added as the
    ``simple_hgn_bias`` mode of both kernel rows."""
    from gigl_tpu_torch.ops import attention

    fwd, seen = attention._fanout_attention_fwd, []

    def recorder(xd, ks, vs, nbr, mask, mode, heads, att, att2, slope,
                 **kw):
        if kw.get("bias") is not None and (
                not seen or nbr.numel() > seen[0][3].numel()):
            seen[:] = [tuple(t.detach() if torch.is_tensor(t) else t
                             for t in (xd, ks, vs, nbr, mask, mode, heads,
                                       att, att2, slope, kw["bias"]))]
        return fwd(xd, ks, vs, nbr, mask, mode, heads, att, att2, slope,
                   **kw)

    attention._fanout_attention_fwd = recorder
    try:
        with torch.no_grad():
            loss_fn()
    finally:
        attention._fanout_attention_fwd = fwd
    check(len(seen) == 1, "the SimpleHGN step launched no K7 with a bias")
    xd, ks, vs, nbr, mask, mode, heads, att, att2, slope, bias = seen[0]
    n, w = nbr.shape
    hd, es = xd.shape[1], xd.element_size()
    stats = torch.empty((n, heads, 2), device=xd.device)

    def k7():
        return attention._fanout_attention_fwd(
            xd, ks, vs, nbr, mask, mode, heads, att, att2, slope,
            stats=stats, bias=bias)

    def k7_plain():
        return attention._fanout_attention_plain(
            xd, ks, vs, nbr, mask, mode, heads, att, att2, slope, bias=bias)

    out = k7()
    err = rel_err(out, k7_plain(), "K7 simple_hgn bias", tol=1e-5)
    valid = int(mask.sum())
    # bytes: xd, the block's slot rows (the dense layout: each read once),
    # the mask and the [W, H] bias read, out written; ops: per valid slot
    # and value a logit term, an exp-weighted add (~4).
    nbytes = (n * hd + n * w * hd + n * hd) * es + n * w + w * heads * 4
    add_mode("fanout_attention", "simple_hgn_bias", {
        "err": err, "ms": cuda_ms(k7), "plain_ms": cuda_ms(k7_plain, reps=3),
        "eager_ms": eager_ms(k7),
        "bound_ms": bound_ms(nbytes, valid * hd * 4)[0],
        "block": [n, w], "heads": heads, "width": hd,
        "dtype": str(xd.dtype).replace("torch.", "")})
    g = torch.randn(out.shape, generator=gen, device=xd.device).to(xd.dtype)

    def k7b():
        return attention.fanout_attention_bwd(
            g, xd, ks, vs, nbr, mask, out, stats, mode, heads, att, att2,
            slope, identity=True, same_table=True, bias=bias)

    def k7b_plain():
        return attention._fanout_attention_bwd_plain(
            g, xd, ks, vs, nbr, mask, out, mode, heads, att, att2, slope,
            True, True, bias=bias)

    got, want = k7b(), k7b_plain()
    err = max(rel_err(getattr(got, f_), getattr(want, f_),
                      f"K7b simple_hgn bias {f_}", tol=1e-4)
              for f_ in ("d_xd", "d_ks", "coef", "d_att"))
    # bytes: g, xd, the slot rows, out, the statistics, the mask and the
    # bias read; d_xd, d_ks and the per-slot coefficient written.
    nbytes = ((3 * n * hd + n * w * hd) * es + n * heads * 8 + n * w
              + w * heads * 4 + (n * hd + n * w * hd) * es
              + n * w * heads * 4)
    add_mode("fanout_attention_bwd", "simple_hgn_bias", {
        "err": err, "ms": cuda_ms(k7b), "plain_ms": cuda_ms(k7b_plain, reps=3),
        "eager_ms": eager_ms(k7b),
        "bound_ms": bound_ms(nbytes, valid * hd * 7)[0],
        "block": [n, w], "heads": heads, "width": hd})


def edge_phases(dev, card, arrays, fb_data, typed, record, add_mode,
                rel_err, unique, run_path):
    """Phase 11 (see the module docstring): edge features. The flagship
    graph gains EDGE_DE fp32 features per edge (numpy seed 8: ogbn-proteins'
    width, a 64 MB table). K6 / K6b gine, K7 / K7b with the edge addend and
    the logit bias, and K11 at the flagship's shapes, then the five paths:
    edge_full_graph (run_full_graph_inference with edge_attr), the ELL
    full-batch trainer with FullBatchData.edge_attr, the live NALPTrainer
    over an edge-featured graph with the label-edge scorer (and
    run_inference over it), typed NALP training with label-edge features
    and the scorer, and SimpleHGN's block form. Returns {path: (launch
    counts, steps or passes)}."""
    from gigl_tpu_torch.graph.csr import HeteroGraph
    from gigl_tpu_torch.inference.inferencer import (
        InferenceConfig, run_full_graph_inference, run_inference)
    from gigl_tpu_torch.models.encoders import GNNEncoder
    from gigl_tpu_torch.models.init import init_params
    from gigl_tpu_torch.models.link_prediction import (
        EdgeFeatureScorer, HeteroLinkPredictionGNN, LinkPredictionDecoder,
        LinkPredictionGNN)
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.ops.attention import (
        _fanout_attention_bwd_plain, _fanout_attention_fwd,
        _fanout_attention_plain, fanout_attention_bwd)
    from gigl_tpu_torch.ops.ell import _ell_edge_grad_plain, ell_edge_grad
    from gigl_tpu_torch.ops.ell_aggregate import (
        _ell_aggregate_fwd, _ell_aggregate_graph_plain,
        _ell_edge_rows_sum_plain, _ell_transpose_plain, ell_edge_rows_sum,
        ell_transpose_aggregate)
    from gigl_tpu_torch.training.dataset import DeviceGraph
    from gigl_tpu_torch.training.full_batch import FullBatchTrainer
    from gigl_tpu_torch.training.hetero_dataset import HeteroDeviceGraph
    from gigl_tpu_torch.training.hetero_trainer import (
        HeteroNALPTrainer, HeteroNALPTrainerConfig)
    from gigl_tpu_torch.training.trainer import (
        NALPTrainer, NALPTrainerConfig)
    from gigl_tpu_torch.types.graph import EdgeType

    src_np, dst_np, x_np = arrays
    erng = np.random.default_rng(8)
    ea_np = erng.normal(size=(E, EDGE_DE)).astype(np.float32)
    ea = torch.as_tensor(ea_np, device=dev)
    fell = fb_data.ell
    big = max(range(len(fell.widths)),
              key=lambda b: fell.boundaries[b + 1] - fell.boundaries[b])
    lo_b, hi_b = fell.boundaries[big], fell.boundaries[big + 1]
    nb_b, mk_b, es_b = fell.nbr[big], fell.mask[big], fell.edge_slots[big]
    n_b, w_b = nb_b.shape
    valid_b = int(mk_b.sum())
    uniq_b = unique(nb_b[mk_b])
    gen = torch.Generator(device=dev).manual_seed(11)
    counts = {}

    # -- K6 gine at the largest bucket (its rows of the one launch over the
    # graph), bf16 [N, 128] rows and [E, 128] edge rows (GINE's hidden
    # width), and over the whole graph (layer: the full-graph GINE pass's
    # launch). bytes: each distinct valid source row and each valid slot's
    # edge row read once, each valid slot's id and edge id, each row's
    # count, [n, 128] written; ops: an add, a max and an add per valid slot
    # and value.
    x6 = torch.randn((N, EDGE_GINE_HID), generator=gen, device=dev).to(
        torch.bfloat16)
    e6 = torch.randn((E, EDGE_GINE_HID), generator=gen, device=dev).to(
        torch.bfloat16)

    def k6g_kernel(rows=(lo_b, hi_b)):
        return _ell_aggregate_fwd(x6, fell, "gine", ea=e6, rows=rows)

    def k6g_plain(rows=(lo_b, hi_b)):
        return _ell_aggregate_graph_plain(x6, fell, "gine", e6, rows)

    err = rel_err(k6g_kernel(), k6g_plain(), "K6 gine")
    err_layer = rel_err(k6g_kernel(None), k6g_plain(None), "K6 gine layer")
    nbytes = ((uniq_b + valid_b) * EDGE_GINE_HID * 2 + valid_b * 8
              + n_b * 4 + n_b * EDGE_GINE_HID * 2)
    src_rows = unique(fell.ent_src[fell.ent_mask])
    layer_bytes = ((src_rows + E) * EDGE_GINE_HID * 2 + E * 8 + N * 4
                   + N * EDGE_GINE_HID * 2)
    add_mode("ell_aggregate", "gine", {
        "err": max(err, err_layer), "ms": cuda_ms(k6g_kernel),
        "plain_ms": cuda_ms(k6g_plain, reps=3),
        "eager_ms": eager_ms(k6g_kernel),
        "bound_ms": bound_ms(nbytes, valid_b * EDGE_GINE_HID * 3)[0],
        "bucket": [n_b, w_b], "edge_rows": valid_b,
        "layer_ms": cuda_ms(lambda: k6g_kernel(None)),
        "layer_plain_ms": cuda_ms(lambda: k6g_plain(None), reps=1),
        "layer_bound_ms": bound_ms(layer_bytes, E * EDGE_GINE_HID * 3)[0]})

    # -- K6b gine over the whole transpose walk at layer 2's [N, 128] fp32
    # cotangent. bytes: the cotangent rows (once each), each source's own
    # row, each entry's edge row, t_row and t_nbr (the slot's row id and
    # flat entry), each entry's ent_edge, t_perm, [N, 128] written; ops: an
    # add and a compare per entry.
    g6, xt6 = (torch.randn((N, EDGE_GINE_HID), generator=gen, device=dev)
               for _ in range(2))
    et6 = torch.randn((E, EDGE_GINE_HID), generator=gen, device=dev)

    def k6bg_kernel():
        return ell_transpose_aggregate(g6, fell, "gine", table=xt6, ea=et6)

    def k6bg_plain():
        return _ell_transpose_plain(g6, fell, "gine", table=xt6, ea=et6)

    err = rel_err(k6bg_kernel(), k6bg_plain(), "K6b gine", tol=1e-5)
    t_slots = sum(int(r_.numel()) for r_ in fell.t_row)
    nbytes = (N * EDGE_GINE_HID * 4 * 3 + E * EDGE_GINE_HID * 4
              + t_slots * 8 + E * 4 + N * 4)
    add_mode("ell_transpose_aggregate", "gine", {
        "err": err, "ms": cuda_ms(k6bg_kernel),
        "plain_ms": cuda_ms(k6bg_plain, reps=1),
        "eager_ms": eager_ms(k6bg_kernel),
        "bound_ms": bound_ms(nbytes, E * EDGE_GINE_HID * 2)[0]})
    del x6, e6, g6, xt6, et6

    # -- K7 with the edge addend at EdgeAttrGAT layer 1's widths (H = 4,
    # Dh = 64, bf16), against K7 without it in the same call. bytes: + each
    # valid slot's edge row and the edge slots; ops: + an add per valid slot
    # and value for the key and for the value.
    hd7 = HID
    xd7, ks7 = (torch.randn(s_, generator=gen, device=dev).to(torch.bfloat16)
                for s_ in ((n_b, hd7), (N, hd7)))
    he7 = torch.randn((E, hd7), generator=gen, device=dev).to(torch.bfloat16)
    att7, att7b = (torch.randn(hd7, generator=gen, device=dev) * 0.2
                   for _ in range(2))

    def k7e_kernel():
        return _fanout_attention_fwd(xd7, ks7, ks7, nb_b, mk_b, "gat",
                                     GAT_HEADS, att7, att7b, 0.2, he=he7,
                                     eidx=es_b)

    def k7_plainrows():
        return _fanout_attention_fwd(xd7, ks7, ks7, nb_b, mk_b, "gat",
                                     GAT_HEADS, att7, att7b, 0.2)

    def k7e_plain():
        return _fanout_attention_plain(xd7, ks7, ks7, nb_b, mk_b, "gat",
                                       GAT_HEADS, att7, att7b, 0.2, he=he7,
                                       eidx=es_b)

    err = rel_err(k7e_kernel(), k7e_plain(), "K7 gat + edge addend")
    base7 = n_b * hd7 * 2 + uniq_b * hd7 * 2 + n_b * w_b * 5 + n_b * hd7 * 2
    nbytes = base7 + valid_b * hd7 * 2 + n_b * w_b * 4
    ms_e, ms_0 = cuda_ms(k7e_kernel), cuda_ms(k7_plainrows)
    add_mode("fanout_attention", "gat_edge_addend", {
        "err": err, "ms": ms_e, "ms_without_addend_same_call": ms_0,
        "plain_ms": cuda_ms(k7e_plain, reps=3),
        "eager_ms": eager_ms(k7e_kernel),
        "bound_ms": bound_ms(nbytes, valid_b * hd7 * 6)[0]})

    # -- K7b with the edge addend (ELL layout, fp32, Dh 64) ------------------
    xdb, ksb, gb = (torch.randn(s_, generator=gen, device=dev)
                    for s_ in ((n_b, hd7), (N, hd7), (n_b, hd7)))
    heb = torch.randn((E, hd7), generator=gen, device=dev)
    stb = torch.empty((n_b, GAT_HEADS, 2), device=dev)
    outb = _fanout_attention_fwd(xdb, ksb, ksb, nb_b, mk_b, "gat", GAT_HEADS,
                                 att7, att7b, 0.2, stats=stb, he=heb,
                                 eidx=es_b)

    def k7be_kernel():
        return fanout_attention_bwd(gb, xdb, ksb, ksb, nb_b, mk_b, outb, stb,
                                    "gat", GAT_HEADS, att7, att7b, 0.2,
                                    he=heb, eidx=es_b)

    def k7be_plain():
        return _fanout_attention_bwd_plain(gb, xdb, ksb, ksb, nb_b, mk_b,
                                           outb, "gat", GAT_HEADS, att7,
                                           att7b, 0.2, he=heb, eidx=es_b)

    got_, want_ = k7be_kernel(), k7be_plain()
    err = max(rel_err(getattr(got_, f_), getattr(want_, f_),
                      f"K7b edge addend {f_}", tol=1e-4)
              for f_ in ("d_xd", "alpha", "coef", "d_att"))
    nbytes = (3 * n_b * hd7 * 4 + uniq_b * hd7 * 4 + valid_b * hd7 * 4
              + n_b * w_b * 9 + n_b * GAT_HEADS * 8
              + n_b * w_b * GAT_HEADS * 8 + n_b * hd7 * 4)
    add_mode("fanout_attention_bwd", "gat_edge_addend", {
        "err": err, "ms": cuda_ms(k7be_kernel),
        "plain_ms": cuda_ms(k7be_plain, reps=1),
        "eager_ms": eager_ms(k7be_kernel),
        "bound_ms": bound_ms(nbytes, valid_b * hd7 * 7)[0]})

    # -- GATv2 with edge rows (ROADMAP B6b): K7 with the edge addend inside
    # its gate (bf16, beside its GATv2 mode without the addend in the same
    # call) and K7b (ELL layout, fp32) at the largest bucket. bytes as the
    # GAT rows above; ops: + the add of the edge row and the leaky per
    # valid slot and value.
    def k7v_kernel(edges=True):
        return _fanout_attention_fwd(
            xd7, ks7, ks7, nb_b, mk_b, "gatv2", GAT_HEADS, att7, None, 0.2,
            he=he7 if edges else None, eidx=es_b if edges else None)

    def k7v_plain():
        return _fanout_attention_plain(xd7, ks7, ks7, nb_b, mk_b, "gatv2",
                                       GAT_HEADS, att7, None, 0.2, he=he7,
                                       eidx=es_b)

    err = rel_err(k7v_kernel(), k7v_plain(), "K7 gatv2 + edge rows")
    nbytes = base7 + valid_b * hd7 * 2 + n_b * w_b * 4
    v2_modes = {("fanout_attention", "gatv2_edge_addend"): {
        "err": err, "ms": cuda_ms(k7v_kernel),
        "ms_without_addend_same_call": cuda_ms(lambda: k7v_kernel(False)),
        "plain_ms": cuda_ms(k7v_plain, reps=3),
        "eager_ms": eager_ms(k7v_kernel),
        "bound_ms": bound_ms(nbytes, valid_b * hd7 * 8)[0]}}
    stv = torch.empty((n_b, GAT_HEADS, 2), device=dev)
    outv = _fanout_attention_fwd(xdb, ksb, ksb, nb_b, mk_b, "gatv2",
                                 GAT_HEADS, att7, None, 0.2, stats=stv,
                                 he=heb, eidx=es_b)

    def k7bv_kernel():
        return fanout_attention_bwd(gb, xdb, ksb, ksb, nb_b, mk_b, outv, stv,
                                    "gatv2", GAT_HEADS, att7, None, 0.2,
                                    he=heb, eidx=es_b)

    def k7bv_plain():
        return _fanout_attention_bwd_plain(gb, xdb, ksb, ksb, nb_b, mk_b,
                                           outv, "gatv2", GAT_HEADS, att7,
                                           None, 0.2, he=heb, eidx=es_b)

    got_, want_ = k7bv_kernel(), k7bv_plain()
    err = max(rel_err(getattr(got_, f_), getattr(want_, f_),
                      f"K7b gatv2 edge rows {f_}", tol=1e-4)
              for f_ in ("d_xd", "alpha", "coef", "d_att"))
    nbytes = (3 * n_b * hd7 * 4 + uniq_b * hd7 * 4 + valid_b * hd7 * 4
              + n_b * w_b * 9 + n_b * GAT_HEADS * 8
              + n_b * w_b * GAT_HEADS * 8 + n_b * hd7 * 4 + hd7 * 4)
    v2_modes[("fanout_attention_bwd", "gatv2_edge_addend")] = {
        "err": err, "ms": cuda_ms(k7bv_kernel),
        "plain_ms": cuda_ms(k7bv_plain, reps=1),
        "eager_ms": eager_ms(k7bv_kernel),
        "bound_ms": bound_ms(nbytes, valid_b * hd7 * 10)[0]}
    del xd7, ks7, he7, xdb, ksb, gb, outb, outv, stv, got_, want_

    # -- K11 at EdgeAttrGAT layer 1 (E = 2M, [E, 256] fp32 out, gat mode),
    # with gine and transformer beside it. The walk in destination order
    # reads ent_mask over all P entries, padding included, and per valid
    # entry ent_edge and ent_row (and ent_src), alpha and coef, each
    # destination's g row (and xd row) once, and for gine each source's x
    # row and each edge's ea row; [E, D] written; ops: 3 per value.
    p_total = int(fell.ent_row.shape[0])
    g11, xd11, x11 = (torch.randn((N, HID), generator=gen, device=dev)
                      for _ in range(3))
    ea11 = torch.randn((E, HID), generator=gen, device=dev)
    al11 = torch.rand((p_total, GAT_HEADS), generator=gen, device=dev)
    cf11 = torch.randn((p_total, GAT_HEADS), generator=gen, device=dev)
    k11 = {}
    for mode in ("gat", "transformer", "gine", "gatv2"):
        kw = {"gat": dict(alpha=al11, coef=cf11, vec=att7,
                          heads=GAT_HEADS),
              "transformer": dict(alpha=al11, coef=cf11, xd=xd11,
                                  heads=GAT_HEADS),
              "gine": dict(x=x11, ea=ea11),
              "gatv2": dict(x=x11, ea=ea11, alpha=al11, coef=cf11,
                            vec=att7, xd=xd11, heads=GAT_HEADS)}[mode]

        def k11_kernel(mode=mode, kw=kw):
            return ell_edge_grad(g11, fell, mode, **kw)

        def k11_plain(mode=mode, kw=kw):
            return _ell_edge_grad_plain(g11, fell, mode, **kw)

        err = rel_err(k11_kernel(), k11_plain(), f"K11 {mode}", tol=1e-6)
        nbytes = (p_total + E * 8 + N * HID * 4 + E * HID * 4
                  + {"gat": E * GAT_HEADS * 8 + HID * 4,
                     "transformer": E * GAT_HEADS * 8 + N * HID * 4,
                     "gine": E * 4 + N * HID * 4 + E * HID * 4,
                     "gatv2": E * GAT_HEADS * 8 + HID * 4 + E * 4
                     + 2 * N * HID * 4 + E * HID * 4}[mode])
        k11[mode] = {"err": err, "ms": cuda_ms(k11_kernel),
                     "plain_ms": cuda_ms(k11_plain, reps=1),
                     "eager_ms": eager_ms(k11_kernel),
                     "bound_ms": bound_ms(nbytes, E * HID * 3)[0],
                     "nbytes": nbytes}
    # the library yardstick: the flat [P, D] cotangent the reference builds,
    # gathered by edge_pos (built beforehand, not timed)
    flat11 = (al11.repeat_interleave(HID // GAT_HEADS, 1)
              * g11[fell.ent_row.long()]
              + cf11.repeat_interleave(HID // GAT_HEADS, 1) * att7[None, :])
    pos11 = fell.edge_pos.long()
    rel_err(torch.index_select(flat11, 0, pos11),
            ell_edge_grad(g11, fell, "gat", alpha=al11, coef=cf11, vec=att7,
                          heads=GAT_HEADS), "index_select vs K11", tol=1e-6)
    record("ell_edge_grad", "gigl_tpu_torch/csrc/ell_edge_grad.cu",
           "gigl_tpu/ops/ell.py:303", max(v["err"] for v in k11.values()),
           k11["gat"]["ms"], k11["gat"]["plain_ms"],
           nbytes=k11["gat"]["nbytes"], nops=E * HID * 3,
           library_ms=cuda_ms(lambda: torch.index_select(flat11, 0, pos11)),
           library_call="torch.index_select of the flat [P, 256] cotangent "
                        "by edge_pos (the reference's _ell_ge_bwd gather; "
                        "the flat block built beforehand, not timed)",
           edges=E, width=HID, dtype="float32",
           eager_ms=k11["gat"]["eager_ms"],
           modes={m_: {k_: v_ for k_, v_ in v.items() if k_ != "nbytes"}
                  for m_, v in k11.items()})
    v2_modes[("ell_edge_grad", "gatv2")] = k11["gatv2"]

    # -- K6b's sum of an [E, 256] fp32 table over EllGraph.t_edge (GATv2
    # with edge rows: the key table's cotangent is K11's gatv2 table summed
    # by source). bytes: each edge's row once, t_edge, t_perm, [N, 256]
    # written; ops: an add a value. Yardstick: index_add_ of the rows by
    # their entries' source (the gathered rows made beforehand). Beside
    # it, the design it replaced: the gate read again in the source walk,
    # K6b's GATv2 mode (each slot's cotangent and query rows, alpha and
    # coef, the key row; the edge row not even added) at the same widths.
    def k6be_kernel():
        return ell_edge_rows_sum(ea11, fell)

    def k6be_plain():
        return _ell_edge_rows_sum_plain(ea11, fell)

    err = rel_err(k6be_kernel(), k6be_plain(), "K6b edge rows", tol=1e-5)
    v_ = fell.ent_mask
    src_e = fell.ent_src[v_].long()
    rows_e = ea11[fell.ent_edge[v_].long()]

    def k6be_lib():
        return torch.zeros((N, HID), device=dev).index_add_(0, src_e, rows_e)

    rel_err(k6be_lib(), k6be_kernel(), "index_add_ vs K6b edge rows",
            tol=1e-5)
    t_slots = sum(int(r_.numel()) for r_ in fell.t_edge)
    v2_modes[("ell_transpose_aggregate", "edge_rows")] = {
        "err": err, "ms": cuda_ms(k6be_kernel),
        "plain_ms": cuda_ms(k6be_plain, reps=1),
        "eager_ms": eager_ms(k6be_kernel),
        "bound_ms": bound_ms(E * HID * 4 + t_slots * 4 + N * 4
                             + N * HID * 4, E * HID)[0],
        "library_ms": cuda_ms(k6be_lib),
        "library_call": "torch.Tensor.index_add_ of the [E, 256] rows by "
                        "their entries' source row (gathered beforehand, "
                        "not timed)",
        "gate_read_alternative_ms": cuda_ms(lambda: ell_transpose_aggregate(
            g11, fell, "gatv2", al11, cf11, att7, GAT_HEADS, rows2=xd11,
            table=x11))}
    del g11, xd11, x11, ea11, al11, cf11, flat11, rows_e, src_e

    # -- edge_full_graph: run_full_graph_inference(edge_attr=) -----------------
    graph_e = HeteroGraph.homogeneous(
        src=src_np, dst=dst_np, num_nodes=N, node_features=x_np,
        edge_features=ea_np)
    x_full = torch.as_tensor(x_np, device=dev)
    for model_name, (conv, hid, kw, kernels) in EDGE_FULL_GRAPH.items():
        enc = GNNEncoder(D, hid, OUT, num_layers=2, conv=conv,
                         conv_kwargs=kw, edge_dim=EDGE_DE,
                         dtype=torch.bfloat16)
        init_params(enc, 0)
        sink = Sink()
        path = f"edge_full_graph_{model_name}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        _build.reset_launches()
        t0 = time.perf_counter()
        run_full_graph_inference(enc, None, graph_e, sink, edge_attr=ea_np,
                                 device=dev)
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t0
        counts[path] = (dict(_build.launches), 1)
        peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
        emit({"phase": "main_path", "path": path,
              "launches": counts[path][0], "seconds": pass_s})
        for k in kernels:
            check(counts[path][0][k] > 0, f"{k} was not launched on {path}")
        if conv == "gine":
            check(counts[path][0]["ell_aggregate"] == 2,
                  f"{path}: K6 launched {counts[path][0]['ell_aggregate']} "
                  "times in two layers, not once a layer")
        embs = sink.table(N, OUT, path)
        with torch.inference_mode(), plain_kernels():
            ref = enc.encode_ell(x_full, fell, ea).float().cpu().numpy()
        scale = float(np.abs(ref).max())
        err = float(np.abs(embs - ref).max())
        # bf16: the kernels and the twins round their fp32 sums in another
        # order (as the full-graph passes above)
        check(err <= 2e-2 * scale, f"{path} differs from the plain pass: "
              f"{err} vs {scale}")
        with torch.inference_mode():
            enc.encode_ell(x_full, fell, ea)          # warm
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                enc.encode_ell(x_full, fell, ea)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            encode_ms = float(np.median(times)) * 1e3
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(FULL_GRAPH_PROFILED):
                    enc.encode_ell(x_full, fell, ea)
                torch.cuda.synchronize()
                window_us = (time.perf_counter() - t0) * 1e6
        emit({"phase": "edge_full_graph_throughput", "model": model_name,
              "max_abs_err": err, "scale": scale, "entry_point_s": pass_s,
              "encode_ms": encode_ms, "nodes_per_s": N / (encode_ms / 1e3),
              "edges_per_s": 2 * E / (encode_ms / 1e3),
              "peak_mem_gb": peak_gb,
              "profile": profile_summary(prof, FULL_GRAPH_PROFILED,
                                         window_us, encode_ms),
              "card": card})
        del enc, sink, embs, ref

    # -- edge_full_batch_train: FullBatchTrainer over the ELL tables with
    # FullBatchData.edge_attr ---------------------------------------------------
    for model_name, (conv, hid, kw, kernels) in EDGE_FULL_BATCH.items():
        path = f"edge_full_batch_{model_name}"
        ea_leaf = torch.nn.Parameter(ea.clone())
        data = dataclasses.replace(fb_data, edge_attr=ea_leaf)
        fbt = FullBatchTrainer(
            GNNEncoder(D, hid, C, num_layers=2, conv=conv, conv_kwargs=kw,
                       edge_dim=EDGE_DE), data,
            optimizer_args={"learning_rate": "1e-2"}, device=dev)
        state = fbt.init_state(0)
        if conv == "gatv2":
            with gatv2_gate_replay() as report:
                vs = step_vs_plain(fbt.encoder, fbt.loss, _build.launches,
                                   extra={"edge_attr": ea_leaf})
                vs.update(report())
        else:
            with edge_gate_flips(fell, "gine" if conv == "gine" else "gat"
                                 ) as explain:
                vs = step_vs_plain(fbt.encoder, fbt.loss, _build.launches,
                                   extra={"edge_attr": ea_leaf},
                                   explain=explain)
        emit({"phase": "edge_full_batch_step_vs_plain", "model": model_name,
              **vs})
        check(vs["loss_rel_err"] <= 1e-5,
              f"{path}: loss differs from the plain step: {vs}")
        check(vs["max_grad_err_rel_to_scale"] <= 1e-4,
              f"{path}: a gradient differs from the plain step: {vs}")
        # the trainer's own data: edge features are inputs, not weights
        fbt.data = dataclasses.replace(fb_data, edge_attr=ea)
        cnt_, nsteps, row = run_path(path, fbt, state, FB_STEPS, FB_WARMUP,
                                     FB_PROFILED, kernels)
        counts[path] = (cnt_, nsteps)
        if conv == "gine":
            check(cnt_["ell_aggregate"] == 2 * nsteps,
                  f"{path}: K6 launched {cnt_['ell_aggregate']} times in "
                  f"{nsteps} steps, not once a layer")
        step_s = row["ms_per_step"] / 1e3
        emit({"phase": "edge_full_batch_train_throughput",
              "model": model_name, "edges_per_step": 2 * E,
              "edges_per_s": 2 * E / step_s, "nodes_per_s": N / step_s,
              **row})
        del fbt, state, data, ea_leaf
    # GATv2 with edge rows: each mode's launches on its paths (K7 on the
    # full-graph pass, the backward modes on the full-batch steps)
    fg_v2, fb_v2 = (counts[f"edge_{k_}_gatv2_edges"] for k_ in
                    ("full_graph", "full_batch"))
    for (kname, mode), entry in v2_modes.items():
        on_fg = kname == "fanout_attention"
        key = {"fanout_attention_bwd": "fanout_attention_bwd",
               "ell_edge_grad": "ell_edge_grad_gatv2",
               "ell_transpose_aggregate": "ell_transpose_edge_rows"}.get(
                   kname, kname)
        c_, n_ = fg_v2 if on_fg else fb_v2
        entry["launches"] = int(c_[key])
        entry["launches_per_" + ("pass" if on_fg else "step")] = c_[key] / n_
        check(entry["launches"] > 0, f"{kname} {mode} was not launched on "
              "its GATv2-with-edge-rows path")
        entry.pop("nbytes", None)
        add_mode(kname, mode, entry)

    # -- edge_nalp_train: the live NALPTrainer over an edge-featured graph,
    # label-edge features on the supervision and hard-negative edges and
    # the scorer; then run_inference over it ------------------------------------
    hard_np = np.stack([erng.integers(0, N, EDGE_HARD),
                        erng.integers(0, N, EDGE_HARD)])
    t0 = time.perf_counter()
    dg_e = DeviceGraph.from_hetero(
        graph_e, supervision_edges=np.stack([src_np, dst_np]),
        hard_neg_edges=hard_np,
        supervision_edge_features=erng.normal(size=(E, EDGE_DE)).astype(
            np.float32),
        hard_neg_edge_features=erng.normal(size=(EDGE_HARD, EDGE_DE)).astype(
            np.float32), device=dev)
    torch.cuda.synchronize()
    emit({"phase": "edge_graph", "seconds": time.perf_counter() - t0,
          "edge_features": [E, EDGE_DE], "hard_negative_edges": EDGE_HARD})
    ncfg = NALPTrainerConfig(fanouts=FANOUTS, num_positives=1,
                             num_hard_negs=1, num_random_negs=R,
                             loss_type="retrieval")
    path = "edge_nalp_train"
    trainer = NALPTrainer(
        LinkPredictionGNN(
            GNNEncoder(D, HID, OUT, num_layers=2, conv="edge_attr_gat",
                       conv_kwargs={"heads": GAT_HEADS}, edge_dim=EDGE_DE),
            LinkPredictionDecoder(), EdgeFeatureScorer(EDGE_DE, 32)),
        dg_e, ncfg, optimizer_args={"learning_rate": "1e-3"}, device=dev)
    state = trainer.init_state(0)
    n_anchor = FB_WARMUP + EDGE_NALP_STEPS + FB_PROFILED
    anchors = (np.arange(BATCH * n_anchor) % N).astype(np.int32).reshape(
        n_anchor, BATCH)
    scorer = {f"edge_scorer.{n_}": p_ for n_, p_ in
              trainer.model.edge_scorer.named_parameters()}
    vs = step_vs_plain(trainer.model.encoder, lambda: trainer.loss(
        trainer.sample_batch(anchors[-1], 0)), _build.launches, extra=scorer)
    emit({"phase": "edge_nalp_step_vs_plain", **vs})
    check(vs["loss_rel_err"] <= 1e-5,
          f"{path}: loss differs from the plain step: {vs}")
    check(vs["max_grad_err_rel_to_scale"] <= 1e-4,
          f"{path}: a gradient differs from the plain step: {vs}")
    cnt_, nsteps, row = run_path(path, trainer, state, EDGE_NALP_STEPS,
                                 FB_WARMUP, FB_PROFILED, EDGE_NALP_KERNELS,
                                 nodes=anchors)
    counts[path] = (cnt_, nsteps)
    per_root = 2 * FANOUTS[0] + FANOUTS[0] * FANOUTS[1]   # bench.py:631-638
    edges_step = per_root * (BATCH + BATCH + BATCH + R)   # anchors, pos,
    emit({"phase": "edge_nalp_train_throughput",           # hard, random
          "edges_per_step": edges_step,
          "edges_per_s": edges_step / (row["ms_per_step"] / 1e3), **row})
    sink = Sink()
    _build.reset_launches()
    t0 = time.perf_counter()
    run_inference(trainer, N, sink, InferenceConfig(batch_size=BATCH))
    torch.cuda.synchronize()
    inf_s = time.perf_counter() - t0
    path_i = "edge_nalp_inference"
    counts[path_i] = (dict(_build.launches), 1)
    emit({"phase": "main_path", "path": path_i, "launches": counts[path_i][0],
          "seconds": inf_s})
    for k in ("sample_uniform", "gather_rows", "fanout_attention"):
        check(counts[path_i][0][k] > 0, f"{k} was not launched on {path_i}")
    embs = sink.table(N, OUT, path_i)
    with torch.inference_mode(), plain_kernels():
        ref0 = trainer.encode_batch(np.arange(BATCH)).float().cpu().numpy()
    err0 = float(np.abs(embs[:BATCH] - ref0).max())
    scale0 = float(np.abs(ref0).max())
    check(err0 <= 1e-4 * scale0, f"{path_i}: batch 0 differs from the "
          f"plain recomputation: {err0} vs {scale0}")
    emit({"phase": "edge_nalp_inference_throughput", "nodes_per_s": N / inf_s,
          "ms_per_batch": inf_s / -(-N // BATCH) * 1e3,
          "batch0_max_abs_err": err0, "scale": scale0, "card": card})
    del trainer, state, dg_e, sink, embs

    # -- typed_label_edge_train and simple_hgn on the typed graph -------------
    tgraph, paths, make_encoder, anchors_t = (
        typed["graph"], typed["paths"], typed["make_encoder"],
        typed["anchors"])
    writes = EdgeType.from_str(WRITES)
    n_writes = int(tgraph.edges[writes].shape[1])
    dg_t = HeteroDeviceGraph.from_hetero(
        tgraph, paths, supervision_edge_type=writes,
        supervision_edges=tgraph.edges[writes], supervision_anchor="dst",
        supervision_edge_features=erng.normal(
            size=(n_writes, EDGE_DE)).astype(np.float32), device=dev)
    tcfg = HeteroNALPTrainerConfig(
        "paper", "author", num_positives=1, num_hard_negs=0,
        num_random_negs=R, loss_type="retrieval", temperature=0.07)
    for conv, path, with_scorer, symmetric in (
            ("hgt", "typed_label_edge_train", True,
             ("encoder.convs.1.a_author.bias",)),
            ("simple_hgn", "simple_hgn", False, ())):
        model = HeteroLinkPredictionGNN(
            make_encoder(conv), LinkPredictionDecoder(),
            EdgeFeatureScorer(EDGE_DE, 32) if with_scorer else None)
        trainer = HeteroNALPTrainer(model, dg_t, paths, tcfg,
                                    optimizer_args={"learning_rate": "1e-3"},
                                    device=dev)
        state = trainer.init_state(0)
        if conv == "simple_hgn":
            # the serving path first: batch 0 of each type against the twins
            for nt in ("paper", "author"):
                ids0 = np.arange(BATCH)
                got0 = trainer.encode_batch(ids0, nt)
                with torch.inference_mode(), plain_kernels():
                    ref0 = trainer.encode_batch(ids0, nt)
                rel_err(got0, ref0, f"simple_hgn encode_batch {nt}",
                        tol=1e-5)
            simple_hgn_bias_timing(
                lambda: trainer.loss(trainer.sample_batch(anchors_t[-1], 0)),
                add_mode, rel_err, gen)
        vs = step_vs_plain(trainer.model, lambda: trainer.loss(
            trainer.sample_batch(anchors_t[-1], 0)), _build.launches,
            gated=False, symmetric=symmetric)
        emit({"phase": f"{path}_step_vs_plain", **vs})
        check(vs["loss_rel_err"] <= 1e-5,
              f"{path}: loss differs from the plain step: {vs}")
        check(vs["max_grad_err_rel_to_scale"] <= 1e-4,
              f"{path}: a gradient differs from the plain step: {vs}")
        cnt_, nsteps, row = run_path(
            path, trainer, state, EDGE_TYPED_STEPS, FB_WARMUP, FB_PROFILED,
            EDGE_TYPED_KERNELS[conv], nodes=anchors_t)
        counts[path] = (cnt_, nsteps)
        emit({"phase": f"{path}_throughput", "model": conv, **row})
        del trainer, state, model
    del dg_t
    return counts


def quantized_phases(dev, card, graph, edges, record, add_mode, unique,
                     make_model, opt_args, anchors, base):
    """Phase 13 (see the module docstring): int8 quantized tables and the
    count-min-sketch logQ correction on the flagship NALP path. K12, K13,
    K14, K2's int8 mode and K5's logQ mode against their plain versions at
    the path's shapes; one training step against the plain twins and the
    sketch after it against a plain recount; then the path (5 + 200
    steps, 20 profiled) and run_inference over every node, each with the
    launch counts reset just before and read just after; then the host
    cost of the path taken apart, in turns within this process: the fp32
    fused-table step of phase 6 (``base``: its graph and config), the int8
    tables without the sketch, and with it. Returns {path: (launch counts,
    steps or passes)}."""
    from gigl_tpu_torch.inference.inferencer import (
        InferenceConfig, run_inference)
    from gigl_tpu_torch.losses.count_min_sketch import (
        _cms_add_plain, _cms_estimate_plain, _cms_hash_plain,
        _cms_probability_plain, cms_add, cms_estimate, cms_init,
        cms_sampling_probability)
    from gigl_tpu_torch.losses.losses import retrieval_masks
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.ops.gather import gather_rows
    from gigl_tpu_torch.ops.hopcache import (
        _neighbor_cache_plain, build_neighbor_cache)
    from gigl_tpu_torch.ops.quantized import (
        _gather_rows_q8_many_plain, _gather_rows_q8_plain, gather_rows_q8,
        gather_rows_q8_many)
    from gigl_tpu_torch.ops.retrieval import (
        _retrieval_bwd_plain, _retrieval_fwd_plain, retrieval_bwd,
        retrieval_fwd)
    from gigl_tpu_torch.sampling.neighbor_sampler import (
        _sample_uniform_plain)
    from gigl_tpu_torch.training.dataset import DeviceGraph
    from gigl_tpu_torch.training.trainer import (
        NALPTrainer, NALPTrainerConfig)

    k1, k2 = FANOUTS
    counts = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qg = DeviceGraph.from_hetero(graph, supervision_edges=edges,
                                 quantize_features=True, device=dev)
    torch.cuda.synchronize()
    xq, csr, deg = qg.node_features, qg.message_csr, qg.degrees
    x32 = torch.as_tensor(np.asarray(graph.node_features[
        graph.metadata.node_types[0]]), device=dev)
    emit({"phase": "quantized_graph", "seconds": time.perf_counter() - t0,
          "feature_bytes": xq.nbytes, "feature_bytes_fp32": N * D * 4})
    qcfg = NALPTrainerConfig(fanouts=FANOUTS, num_random_negs=R,
                             loss_type="retrieval", num_positives=1,
                             cached_hop=True, quantize_cache=True,
                             use_cms_correction=True)
    # a trainer for the checks (its launches are not the path's)
    chk = NALPTrainer(make_model(), qg, qcfg, optimizer_args=opt_args)
    state = chk.init_state(0, batch_size=BATCH)
    a0 = torch.as_tensor(anchors[0], device=dev)

    # -- K12 at the step's largest hydrate (the 512 x 15 first-hop rows,
    # with the degrees) and over the whole table. bytes: ids read, each
    # distinct int8 row with its scale and degree read once, the fp32 rows
    # and degrees written; ops: one multiply per value.
    lvl = chk.graph.sample_hop_blocks_tabularized(a0, (k1,)).node_ids[1]
    ids_whole = torch.arange(N, dtype=torch.int32, device=dev)

    def k12_case(ids):
        def kern():
            return gather_rows_q8(xq.q, xq.scale, ids, torch.float32, deg)

        def plain():
            return _gather_rows_q8_plain(xq.q, xq.scale, ids, torch.float32,
                                         deg)

        got, want = kern(), plain()
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              "K12 gather_rows_q8 is not bit-equal")
        m, u = ids.numel(), unique(ids)
        nbytes, nops = m * 4 + u * (D + 8) + m * (D * 4 + 4), m * D
        return {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
                "eager_ms": eager_ms(kern),
                "k3_fp32_same_rows_ms": cuda_ms(
                    lambda: gather_rows(x32, ids, deg)),
                "bound_ms": bound_ms(nbytes, nops)[0], "nbytes": nbytes,
                "nops": nops, "rows": m, "distinct_rows": u}

    # -- K12's segmented launch: a quantized inference batch's four gathers
    # (roots 0-511 and their 7,680 first-hop rows, from the features with
    # the degrees and from the int8 cache) and a live (15, 10) tree's three
    # feature levels, each one launch, bit-equal to the gathers one by one
    # through the twin; beside it the same kernel launched once a gather
    # (four launches a batch, as the paths launched K12 before one launch
    # took a batch; the first version's own kernel is timed in turns by
    # scripts/kernel_sweep.py q8). bytes: the ids (shared by the two
    # tables) read once, each table's distinct rows (with scale and degree)
    # read once, every output written once; ops: one multiply a value.
    cq = chk.graph.nbr_cache

    def k12_segs(levels, both):
        segs = [(xq.q, xq.scale, ids, torch.float32, deg) for ids in levels]
        if both:
            segs += [(cq.q, cq.scale, ids, cq.out_dtype, None)
                     for ids in levels]
        return levels, both, segs

    cuda_counts = {}

    def k12_checked(label, case):
        _, _, segs = case
        before = _build.launches["gather_rows_q8"]
        got = gather_rows_q8_many(segs)
        want = _gather_rows_q8_many_plain(segs)
        check(_build.launches["gather_rows_q8"] == before + 1,
              f"K12 ({label}): not one launch")
        cuda_n = device_launches(lambda: gather_rows_q8_many(segs),
                                 "gather_rows_q8")
        check(cuda_n == 1, f"K12 ({label}): {cuda_n} CUDA launches, not 1")
        cuda_counts[label] = cuda_n
        check(all(torch.equal(g_[0], w_[0]) and (
            g_[1] is None if w_[1] is None else torch.equal(g_[1], w_[1]))
            for g_, w_ in zip(got, want)),
            f"K12's segmented launch ({label}) is not bit-equal to its twin")

    def k12_many(case):
        levels, both, segs = case
        m = sum(ids.numel() for ids in levels)
        u = unique(torch.cat([ids.reshape(-1) for ids in levels]))
        nbytes = m * 4 + u * (D + 8) + m * (D * 4 + 4)
        nops = m * D
        if both:
            cd = cq.q.shape[1]
            nbytes += u * (cd + 4) + m * cd * cq.out_dtype.itemsize
            nops += m * cd
        return {"segments": len(segs), "rows": m, "distinct_rows": u,
                "ms": cuda_ms(lambda: gather_rows_q8_many(segs)),
                "kept_kernel_a_launch_a_gather_ms": cuda_ms(
                    lambda: [gather_rows_q8_many([s_]) for s_ in segs]),
                "plain_ms": cuda_ms(lambda: _gather_rows_q8_many_plain(segs)),
                "eager_ms": eager_ms(lambda: gather_rows_q8_many(segs)),
                "bound_ms": bound_ms(nbytes, nops)[0]}

    k12_cases = {
        "quantized inference batch": k12_segs(
            chk.graph.sample_hop_blocks_tabularized(torch.arange(
                BATCH, dtype=torch.int32, device=dev), (k1,)).node_ids,
            True),
        "live tree": k12_segs(chk.graph.sample_hop_blocks(
            a0, FANOUTS).node_ids, False)}
    for k_, v_ in k12_cases.items():
        k12_checked(k_, v_)
    hyd, whole = k12_case(lvl), k12_case(ids_whole)
    batch, live_tree = (k12_many(v_) for v_ in k12_cases.values())
    record("gather_rows_q8", "gigl_tpu_torch/csrc/gather_rows_q8.cu",
           "gigl_tpu/ops/quantized.py:98", 0.0, hyd["ms"], hyd["plain_ms"],
           nbytes=hyd["nbytes"], nops=hyd["nops"], rows=hyd["rows"],
           distinct_rows=hyd["distinct_rows"], width=D,
           k3_fp32_same_rows_ms=hyd["k3_fp32_same_rows_ms"],
           eager_ms=hyd["eager_ms"], batch_ms=batch["ms"],
           batch_bound_ms=batch["bound_ms"],
           batch_kept_kernel_a_launch_a_gather_ms=batch[
               "kept_kernel_a_launch_a_gather_ms"],
           whole_table={k_: v_ for k_, v_ in whole.items()
                        if k_ not in ("nbytes", "nops")},
           modes={"inference_batch": batch, "live_tree": live_tree},
           cuda_launches=cuda_counts)

    # -- K13 / K14 on the candidate ids of a real first step (C = 1024:
    # the positives, then the random negatives)
    batch0 = chk.sample_batch(a0, 0)
    cids = torch.cat([batch0.pos.reshape(-1), batch0.random_neg])
    check(cids.shape == (BATCH + R,), "step 0 has not 1024 candidates")
    sk0 = cms_init(device=dev)
    got, want = cms_add(sk0, cids), _cms_add_plain(sk0, cids)
    check(torch.equal(got.table, want.table)
          and torch.equal(got.total, want.total)
          and int(got.total) == BATCH + R and not sk0.table.any(),
          "K13 cms_add is not bit-equal to its recount")
    depth, width = got.depth, got.width
    buckets = _cms_hash_plain(cids, depth, width)
    flat_b = (buckets + torch.arange(depth, device=dev)[:, None] * width
              ).reshape(-1)
    ones = torch.ones_like(flat_b, dtype=torch.int32)
    scratch = torch.zeros(depth * width, dtype=torch.int32, device=dev)
    # bytes: the table read and the new one written, the ids, the totals
    record("cms_add", "gigl_tpu_torch/csrc/cms.cu",
           "gigl_tpu/losses/count_min_sketch.py:50", 0.0,
           cuda_ms(lambda: cms_add(sk0, cids)),
           cuda_ms(lambda: _cms_add_plain(sk0, cids)),
           nbytes=2 * depth * width * 4 + cids.numel() * 4 + 8,
           nops=cids.numel() * depth * 12,
           library_ms=cuda_ms(lambda: scratch.scatter_add_(0, flat_b, ones)),
           library_call="scatter_add_ of ones into the flat table by the "
                        "buckets (hashed beforehand, not timed)",
           ids=cids.numel(), distinct_ids=unique(cids), depth=depth,
           width=width, eager_ms=eager_ms(lambda: cms_add(sk0, cids)))
    # the same ids into a 5 x 16384 sketch (320 KB, past the 48 KB that
    # K13's first design could stage in one block)
    skw = cms_init(5, 16384, device=dev)
    got_w, want_w = cms_add(skw, cids), _cms_add_plain(skw, cids)
    check(torch.equal(got_w.table, want_w.table)
          and torch.equal(got_w.total, want_w.total) and not skw.table.any(),
          "K13 cms_add at 5 x 16384 is not bit-equal to its recount")
    flat_w = (_cms_hash_plain(cids, 5, 16384)
              + torch.arange(5, device=dev)[:, None] * 16384).reshape(-1)
    scratch_w = torch.zeros(5 * 16384, dtype=torch.int32, device=dev)
    add_mode("cms_add", "wide_5x16384", {
        "bit_equal": True, "ms": cuda_ms(lambda: cms_add(skw, cids)),
        "plain_ms": cuda_ms(lambda: _cms_add_plain(skw, cids)),
        "library_ms": cuda_ms(
            lambda: scratch_w.scatter_add_(0, flat_w, ones)),
        "bound_ms": bound_ms(2 * 5 * 16384 * 4 + cids.numel() * 4 + 8,
                             cids.numel() * 5 * 12)[0],
        "eager_ms": eager_ms(lambda: cms_add(skw, cids))})
    # K14 on a sketch that has counted the candidates of the first
    # MID_STEPS steps (collisions make the estimates differ by column)
    mid = got
    for k_ in range(1, MID_STEPS):
        b_ = chk.sample_batch(torch.as_tensor(anchors[k_], device=dev), k_)
        mid = cms_add(mid, torch.cat([b_.pos.reshape(-1), b_.random_neg]))
    got = cms_add(mid, cids)
    want = _cms_add_plain(mid, cids)
    est = cms_estimate(got, cids)
    prob = cms_sampling_probability(got, cids)
    check(torch.equal(got.table, want.table)
          and torch.equal(est, _cms_estimate_plain(want, cids))
          and torch.equal(prob, _cms_probability_plain(want, cids)),
          "K14 cms_estimate is not bit-equal")
    cells = sum(unique(buckets[r_]) for r_ in range(depth))
    # bytes: the ids, the table cells the ids hash to, total read, the
    # probabilities written
    record("cms_estimate", "gigl_tpu_torch/csrc/cms.cu",
           "gigl_tpu/losses/count_min_sketch.py:61", 0.0,
           cuda_ms(lambda: cms_sampling_probability(got, cids)),
           cuda_ms(lambda: _cms_probability_plain(got, cids)),
           nbytes=cids.numel() * 8 + cells * 4 + 4,
           nops=cids.numel() * depth * 13, ids=cids.numel(),
           table_cells_read=cells, sketch_total=int(got.total),
           distinct_estimates=unique(est),
           ms_of="K14 after K14: launches replayed from one CUDA graph, "
                 "each starting while the one before finishes, which no "
                 "path does; the yardstick is the K13 -> K14 pair, "
                 "modes[...]['pair_ms']",
           est_ms=cuda_ms(lambda: cms_estimate(got, cids)),
           eager_ms=eager_ms(lambda: cms_sampling_probability(got, cids)))
    # K14 behind K13, as the step runs them (K14 a dependent launch that
    # may start while K13 finishes): the pair replayed from one CUDA graph,
    # beside K13 alone; and both at 65,536 ids over a 5 x 16384 sketch.
    # The pair's time is K14's yardstick: its own duration now includes
    # its wait for K13.
    rng14 = np.random.default_rng(14)
    ids_w = torch.from_numpy(rng14.integers(0, N, 65_536).astype(
        np.int32)).to(dev)
    sk_w = cms_add(cms_add(cms_init(5, 16384, device=dev), ids_w), cids)
    for label, sk_, ids_ in (("pair_1024_5x2048", mid, cids),
                             ("wide_65536_5x16384", sk_w, ids_w)):
        def k14(sk_=sk_, ids_=ids_):
            return cms_sampling_probability(sk_, ids_)

        def pair(sk_=sk_, ids_=ids_):
            return k14(cms_add(sk_, ids_), ids_)

        nxt_p = _cms_add_plain(sk_, ids_)
        check(torch.equal(k14(), _cms_probability_plain(sk_, ids_))
              and torch.equal(pair(), _cms_probability_plain(nxt_p, ids_))
              and torch.equal(cms_estimate(sk_, ids_),
                              _cms_estimate_plain(sk_, ids_)),
              f"K14 {label} is not bit-equal")
        cells_ = sum(unique(_cms_hash_plain(ids_, sk_.depth, sk_.width)[r_])
                     for r_ in range(sk_.depth))
        add_mode("cms_estimate", label, {
            "bit_equal": True, "ids": ids_.numel(), "depth": sk_.depth,
            "width": sk_.width, "ms": cuda_ms(k14),
            "plain_ms": cuda_ms(lambda sk_=sk_, ids_=ids_:
                                _cms_probability_plain(sk_, ids_)),
            "bound_ms": bound_ms(ids_.numel() * 8 + cells_ * 4 + 4,
                                 ids_.numel() * sk_.depth * 13)[0],
            "pair_ms": cuda_ms(pair),
            "k13_alone_ms": cuda_ms(lambda sk_=sk_, ids_=ids_:
                                    cms_add(sk_, ids_)),
            "eager_pair_ms": eager_ms(pair)})
    del sk_w, ids_w

    # -- K2 in its int8 mode over the whole graph (mean of 10 rows), beside
    # the fp32 mode in the same call. bytes: indptr, the drawn slots, each
    # drawn int8 row and scale once, the fp32 table written.
    out2 = torch.empty((N, D), dtype=torch.float32, device=dev)
    plain2 = torch.empty_like(out2)

    def k2q():
        return build_neighbor_cache(csr, xq, fanout=k2, seed=0, hop_key=2,
                                    agg="mean", out=out2)

    def k2q_plain():
        return _neighbor_cache_plain(csr, xq, k2, 0, 2, "mean", None, plain2)

    k2q()
    k2q_plain()
    torch.testing.assert_close(out2, plain2, rtol=1e-5, atol=1e-6)
    d_ids, d_mask, d_slots = _sample_uniform_plain(csr.indptr, csr.indices,
                                                   ids_whole, k2, 0, 2)
    nbytes = ((N + 1) * 4 + unique(d_slots[d_mask]) * 4
              + unique(d_ids[d_mask]) * (D + 4) + N * D * 4)
    add_mode("build_neighbor_cache", "int8", {
        "err": float((out2 - plain2).abs().max()), "ms": cuda_ms(k2q),
        "ms_fp32_same_call": cuda_ms(lambda: build_neighbor_cache(
            csr, x32, fanout=k2, seed=0, hop_key=2, agg="mean", out=out2)),
        "plain_ms": cuda_ms(k2q_plain, reps=5), "eager_ms": eager_ms(k2q),
        "bound_ms": bound_ms(nbytes, int(d_mask.sum()) * D * 2 + N * D)[0]})

    # -- K5 with the logQ term on the step's [512, 1024] bf16 scores
    with torch.no_grad():
        q0, pos0, _, rand0 = chk._scores(chk.graph, batch0, train=True)
        scores = chk.model.decode_all_pairs(
            q0, torch.cat([pos0.reshape(BATCH, OUT), rand0]))
    check(scores.shape == (BATCH, BATCH + R)
          and scores.dtype == torch.bfloat16, "quantized step-0 scores are "
          "not [512, 1024] bf16")
    kw5 = dict(temperature=qcfg.temperature, query_ids=batch0.anchors,
               candidate_ids=cids, remove_accidental_hits=True,
               query_mask=batch0.pos_mask.reshape(-1),
               candidate_mask=torch.cat([batch0.pos_mask.reshape(-1),
                                         torch.ones(R, dtype=torch.bool,
                                                    device=dev)]))
    masks = retrieval_masks(candidate_sampling_probability=prob, **kw5)
    masks0 = retrieval_masks(**kw5)
    loss_k, cnt_k, lse_k, _ = retrieval_fwd(scores, masks)
    loss_p, cnt_p, lse_p, _ = _retrieval_fwd_plain(scores, masks)
    g5 = 1.0 / torch.clamp(cnt_k.float(), min=1.0)
    ds_k = retrieval_bwd(scores, masks, lse_k, g5)
    ds_p = _retrieval_bwd_plain(scores, masks, lse_p, g5)
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    check(int(cnt_k) == int(cnt_p) and loss_rel <= 1e-5,
          f"K5 logQ loss_sum relative error {loss_rel} > 1e-5")
    check(float(loss_k) != float(retrieval_fwd(scores, masks0)[0]),
          "the logQ term did not move K5's loss")
    ds_scale = float(ds_p.float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(ds_scale)) - 7)
    err5 = float((ds_k.float() - ds_p.float()).abs().max())
    check(err5 <= ulp, f"K5 logQ dS error {err5} > one bf16 ulp {ulp}")
    qc = BATCH * (BATCH + R)
    ids_bytes = BATCH * 4 + (BATCH + R) * 4 + BATCH + (BATCH + R)
    fwd_ms = cuda_ms(lambda: retrieval_fwd(scores, masks))
    bwd_ms = cuda_ms(lambda: retrieval_bwd(scores, masks, lse_k, g5))
    # bytes: K5's (see its row) and the [C] probabilities, read by each pass
    add_mode("retrieval_loss", "logq", {
        "err": err5, "loss_rel_err": loss_rel, "ms": fwd_ms + bwd_ms,
        "fwd_ms": fwd_ms, "bwd_ms": bwd_ms,
        "ms_without_logq_same_call": cuda_ms(
            lambda: retrieval_fwd(scores, masks0)) + cuda_ms(
            lambda: retrieval_bwd(scores, masks0, lse_k, g5)),
        "plain_ms": cuda_ms(lambda: _retrieval_fwd_plain(scores, masks))
        + cuda_ms(lambda: _retrieval_bwd_plain(scores, masks, lse_p, g5)),
        "bound_ms": bound_ms((qc * 2 + ids_bytes + (BATCH + R) * 4
                              + BATCH * 8 + 8)
                             + (qc * 4 + ids_bytes + (BATCH + R) * 4
                                + BATCH * 4 + 4), qc * 15)[0],
        "scores": [BATCH, BATCH + R], "dtype": "bfloat16"})
    del scores, ds_k, ds_p

    # -- one training step against the plain twins, then the sketch after a
    # real step against a plain recount of its candidates
    vs = step_vs_plain(chk.model,
                       lambda: chk.loss_and_sketch(batch0, state.cms)[0],
                       _build.launches, gated=False)
    emit({"phase": "quantized_train_step_vs_plain", **vs})
    # bf16 compute, as the flagship step's check (phase 5): K4's and K5's
    # fp32 sums rounded in another order
    check(vs["loss_rel_err"] <= 1e-2,
          f"quantized step: loss differs from the plain step: {vs}")
    check(vs["max_grad_err_rel_to_scale"] <= 5e-2,
          f"quantized step: a gradient differs from the plain step: {vs}")
    state, _ = chk.train_step(state, anchors[0])
    recount = _cms_add_plain(cms_init(device=dev), cids)
    check(torch.equal(state.cms.table, recount.table)
          and int(state.cms.total) == BATCH + R,
          "the sketch after a step differs from a recount of its candidates")
    del chk, state

    # -- the path: refresh (K2 int8 + the host quantize), 5 + 200 steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    _build.reset_launches()
    t0 = time.perf_counter()
    trainer = NALPTrainer(make_model(), qg, qcfg, optimizer_args=opt_args)
    state = trainer.init_state(0, batch_size=BATCH)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(1)
    state, warm = trainer.train_steps(state, anchors[:WARMUP], gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, losses = trainer.train_steps(state, anchors, gen)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    path = "quantized_train"
    counts[path] = (dict(_build.launches), WARMUP + STEPS)
    peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
    emit({"phase": "main_path", "path": path, "launches": counts[path][0],
          "init_s": init_s, "steps": WARMUP + STEPS})
    for k in QUANT_TRAIN_KERNELS:
        check(counts[path][0][k] > 0, f"{k} was not launched on {path}")
    # one K12 launch an encode chain (anchors, positives, random negatives)
    check(counts[path][0]["gather_rows_q8"] == 3 * (WARMUP + STEPS),
          f"{path}: {counts[path][0]['gather_rows_q8']} K12 launches, not 3 "
          f"a step")
    total = int(state.cms.total)
    check(total == (WARMUP + STEPS) * (BATCH + R),
          f"the sketch counted {total}, not {WARMUP + STEPS} x 1024")
    losses = losses.float().cpu().numpy()
    check(np.isfinite(losses).all() and np.isfinite(
        warm.float().cpu().numpy()).all(), f"{path}: loss not finite")
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    check(last < first, f"{path}: loss did not decrease: {first} -> {last}")
    ms_step = train_s / STEPS * 1e3
    edges_per_step = (2 * k1 + k1 * k2) * (BATCH + BATCH + R)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = trainer.train_steps(state, anchors[:PROFILED], gen)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.refresh_cache(1)
    torch.cuda.synchronize()
    refresh_ms = (time.perf_counter() - t0) * 1e3
    cache = trainer.graph.nbr_cache
    # the step's host cost in turns (A B C C B A, AB_STEPS each)
    dg, cfg = base
    variants = {"fp32_fused": NALPTrainer(make_model(), dg, cfg,
                                          optimizer_args=opt_args),
                "int8_no_sketch": NALPTrainer(
                    make_model(), qg, dataclasses.replace(
                        qcfg, use_cms_correction=False),
                    optimizer_args=opt_args),
                "int8_sketch": trainer}
    ab_state = {k_: (state if k_ == "int8_sketch" else
                     t_.init_state(0, batch_size=BATCH))
                for k_, t_ in variants.items()}
    ab_ms = {k_: [] for k_ in variants}
    for k_ in list(variants) + list(variants)[::-1]:
        t_ = variants[k_]
        ab_state[k_], _ = t_.train_steps(ab_state[k_], anchors[:5], gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ab_state[k_], _ = t_.train_steps(ab_state[k_], anchors[:AB_STEPS],
                                         gen)
        torch.cuda.synchronize()
        ab_ms[k_].append((time.perf_counter() - t0) / AB_STEPS * 1e3)
    state = ab_state["int8_sketch"]
    del variants, ab_state
    emit({"phase": "quantized_train_throughput", "steps": STEPS,
          "ms_per_step": ms_step, "edges_per_step": edges_per_step,
          "edges_per_s": edges_per_step / (ms_step / 1e3),
          "loss_first20": first, "loss_last20": last,
          "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
          "sketch_total": total, "peak_mem_gb": peak_gb,
          "feature_table_bytes": xq.nbytes,
          "cache_table_bytes": cache.nbytes,
          "fp32_table_bytes_each": N * D * 4,
          "refresh_ms": refresh_ms,
          "ms_per_step_in_turns": ab_ms,
          "profile": profile_summary(prof, PROFILED, window_us, ms_step),
          "card": card})

    # -- run_inference over every node on the quantized tables
    sink = Sink()
    _build.reset_launches()
    t0 = time.perf_counter()
    run_inference(trainer, N, sink, InferenceConfig(batch_size=BATCH))
    torch.cuda.synchronize()
    inf_s = time.perf_counter() - t0
    path_i = "quantized_inference"
    counts[path_i] = (dict(_build.launches), 1)
    emit({"phase": "main_path", "path": path_i, "launches": counts[path_i][0],
          "seconds": inf_s})
    for k in QUANT_INFERENCE_KERNELS:
        check(counts[path_i][0][k] > 0, f"{k} was not launched on {path_i}")
    n_batches = -(-N // BATCH)
    check(counts[path_i][0]["gather_rows_q8"] == n_batches,
          f"{path_i}: {counts[path_i][0]['gather_rows_q8']} K12 launches, "
          f"not one a batch ({n_batches})")
    embs = sink.table(N, OUT, path_i)
    with torch.inference_mode(), plain_kernels():
        ref0 = trainer.encode_batch(np.arange(BATCH)).float().cpu().numpy()
    err0 = float(np.abs(embs[:BATCH] - ref0).max())
    scale0 = float(np.abs(ref0).max())
    # bf16, as batch 0 of the sampled-inference path (phase 4)
    check(err0 <= 3e-2 * scale0, f"{path_i}: batch 0 differs from the plain "
          f"recomputation: {err0} vs {scale0}")
    emit({"phase": "quantized_inference_throughput", "nodes": N,
          "nodes_per_s": N / inf_s, "ms_per_batch": inf_s / n_batches * 1e3,
          "batch0_max_abs_err": err0, "scale": scale0, "card": card})
    del trainer, state, sink, embs, qg
    return counts


@contextlib.contextmanager
def spy(module, name, keep):
    """Record ``keep(args, kwargs)`` for every call of ``module.name`` while
    the call itself runs unchanged; yields the list of records."""
    orig = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        calls.append(keep(args, kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def partitioned_phases(dev, card, dg, record, add_mode, unique, make_model,
                       opt_args):
    """Phase 14 (see the module docstring): the partitioned NALP trainer
    over PART_SHARDS shards on the card. The loss checks (fp32): the
    per-shard pool against the replicated trainer's per-shard losses, the
    ring against K5 over the global score matrix, each pool's step against
    the plain twins; K15, K16, K17 and K1's row-offset mode at the step's
    largest shapes against their twins; then both pools' training paths
    (bf16, the sketch on) and encode_batch over every node, each with the
    launch counts reset just before and read just after. Returns {path:
    (launch counts, steps or passes)} and the per-shard pool's trainer."""
    from gigl_tpu_torch.losses import sharded_retrieval as sr
    from gigl_tpu_torch.models.encoders import GNNEncoder
    from gigl_tpu_torch.models.link_prediction import (
        LinkPredictionDecoder, LinkPredictionGNN)
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.parallel import feature_lookup as fl
    from gigl_tpu_torch.parallel.mesh import make_mesh
    from gigl_tpu_torch.sampling.neighbor_sampler import (
        _sample_uniform_plain, sample_uniform)
    from gigl_tpu_torch.training.dist_sampled import (
        PartitionedGraph, PartitionedNALPTrainer)
    from gigl_tpu_torch.training.trainer import (
        NALPTrainer, NALPTrainerConfig)

    k1, k2 = FANOUTS
    shards = PART_SHARDS
    counts = {}
    # the NALP path reads no node labels (a partitioned graph takes none)
    dg = dataclasses.replace(dg, node_labels=None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh = make_mesh(shards)
    pg = PartitionedGraph.build(dg, mesh)
    torch.cuda.synchronize()
    emit({"phase": "partitioned_graph", "seconds": time.perf_counter() - t0,
          "shards": shards, "rows_per_shard": pg.rows_per_shard,
          "feat_deg_bytes_per_shard": pg.feat_deg[0].nbytes,
          "msg_edges_per_shard": [int(ip[-1]) for ip in pg.msg_indptr]})
    base = dict(fanouts=FANOUTS, num_random_negs=R, loss_type="retrieval",
                num_positives=1)

    def fp32_model():
        return LinkPredictionGNN(GNNEncoder(D, HID, OUT, num_layers=2,
                                            conv="graphsage"),
                                 LinkPredictionDecoder())

    def trainer_for(model, **kw):
        return PartitionedNALPTrainer(
            model, pg, mesh, NALPTrainerConfig(**base, **kw),
            optimizer_args=opt_args, capacity_factor=PART_CAPACITY,
            overflow_policy="raise")

    n_anchor = PART_WARMUP + PART_STEPS + PART_PROFILED
    anchors = (np.arange(BATCH * n_anchor) % N).astype(np.int32).reshape(
        n_anchor, BATCH)
    a0 = torch.as_tensor(anchors[0], device=dev)

    # -- the losses against the replicated trainer (fp32, no sketch): the
    # per-shard pool is the mean of the replicated per-shard losses (the
    # same anchors and draws); the ring's global pool is K5 over the whole
    # batch's [512, 1024] score matrix
    per = trainer_for(fp32_model())
    per.init_state(0)
    params = {k_: v_.clone() for k_, v_ in per.model.state_dict().items()}
    ring = trainer_for(fp32_model(), global_candidate_pool=True)
    ring.init_state(params=params)
    rep = NALPTrainer(fp32_model(), dg, NALPTrainerConfig(**base))
    rep.init_state(params=params)
    with torch.no_grad():
        loss_per = float(per.loss_and_sketch(a0, 0)[0])
        loss_ring = float(ring.loss_and_sketch(a0, 0)[0])
        shard_losses = [float(rep.loss(rep.sample_batch(a_, 0)))
                        for a_ in a0.reshape(shards, -1)]
        loss_full = float(rep.loss(rep.sample_batch(a0, 0)))
    mean = float(np.mean(shard_losses))
    per_rel = abs(loss_per - mean) / abs(mean)
    ring_rel = abs(loss_ring - loss_full) / abs(loss_full)
    emit({"phase": "partitioned_loss_checks", "per_shard_pool": loss_per,
          "replicated_per_shard_mean": mean, "per_shard_rel_err": per_rel,
          "ring_pool": loss_ring, "k5_global_matrix": loss_full,
          "ring_rel_err": ring_rel})
    check(per_rel <= 1e-5, f"the per-shard pool's loss {loss_per} is not "
          f"the mean of the replicated per-shard losses {mean}")
    check(ring_rel <= 1e-5, f"the ring's loss {loss_ring} is not K5 over "
          f"the global score matrix {loss_full}")
    del per, rep

    # -- each pool's step (fp32, the sketch on) against the plain twins;
    # the ring step's routed calls and folds recorded for the kernel rows
    for pool in ("per_shard", "ring"):
        t_ = trainer_for(fp32_model(), use_cms_correction=True,
                         global_candidate_pool=pool == "ring")
        st = t_.init_state(0)
        loss_fn = lambda: t_.loss_and_sketch(a0, 0, st.cms)[0]  # noqa: E731
        vs = step_vs_plain(t_.model.encoder, loss_fn, _build.launches)
        emit({"phase": "partitioned_step_vs_plain", "pool": pool, **vs})
        check(vs["loss_rel_err"] <= 1e-5,
              f"partitioned {pool} step: loss differs from the plain step: "
              f"{vs}")
        check(vs["max_grad_err_rel_to_scale"] <= 1e-4,
              f"partitioned {pool} step: a gradient differs from the plain "
              f"step: {vs}")
    with spy(fl, "route_requests",
             lambda a, k: (a[0].clone(),) + tuple(a[1:])) as routes, \
            spy(fl, "unroute_rows",
                lambda a, k: tuple(x.clone() for x in a)) as unroutes, \
            spy(fl, "sample_uniform",
                lambda a, k: tuple(a[:2]) + (a[2].clone(),) + tuple(a[3:])
                + (k["row_offset"],)) as draws, \
            spy(sr, "ring_fold", lambda a, k: a[:4]) as folds, \
            spy(sr, "ring_block_bwd", lambda a, k: a) as bwds:
        loss = t_.loss_and_sketch(a0, 0, st.cms)[0]
        loss.backward()
    torch.cuda.synchronize()
    del t_, st, loss

    # -- K15 at the step's largest routed lookup: every shard's request
    # vector in one call ([P, G]: the union gather), and one vector alone
    # (mode single). bytes: the ids read, owner / pos / ok and the [P, C]
    # tables written, per vector; ops: ~12 integer ops per id. Yardstick:
    # a stable sort of each vector's owners with their counts (scatter_add_,
    # bincount's work without its host sync) and the positions scattered
    # back, the vectors batched (owners offset by P a vector).
    ids15, rows15, p15, cap15 = max(routes, key=lambda r_: r_[0].numel())
    check(ids15.dim() == 2 and ids15.shape[0] == p15,
          f"K15: the step routed {tuple(ids15.shape)}, not every shard's "
          "vector in one call")
    k15 = {}
    for mode, ids_m in (("batched", ids15), ("single", ids15[0])):
        got = fl.route_requests(ids_m, rows15, p15, cap15)
        want = fl._route_requests_plain(ids_m, rows15, p15, cap15)
        check(all(torch.equal(g_, w_) for g_, w_ in zip(got, want)),
              f"K15 route_requests ({mode}) is not bit-equal")
        s15, g15 = ids_m.reshape(-1, ids_m.shape[-1]).shape
        owner64 = (torch.div(ids_m.reshape(s15, g15).long(), rows15,
                             rounding_mode="floor").clamp(0, p15 - 1)
                   + torch.arange(s15, device=dev)[:, None] * p15
                   ).reshape(-1)
        ones64 = torch.ones_like(owner64)
        iota = torch.arange(s15 * g15, device=dev)

        def k15_library(owner64=owner64, ones64=ones64, iota=iota,
                        n_=s15 * p15):
            srt, perm = torch.sort(owner64, stable=True)
            cnt = torch.zeros(n_, dtype=torch.int64,
                              device=dev).scatter_add_(0, owner64, ones64)
            pos = torch.empty_like(perm)
            pos[perm] = iota - (torch.cumsum(cnt, 0) - cnt)[srt]
            return pos

        check(torch.equal(k15_library().to(torch.int32).reshape(
            got[2].shape), got[2]),
              f"the K15 yardstick's positions differ from K15's ({mode})")
        b15, by15 = bound_ms(s15 * (g15 * 4 + g15 * 9 + p15 * cap15 * 4),
                             s15 * g15 * 12)
        k15[mode] = {
            "ms": cuda_ms(lambda ids_m=ids_m: fl.route_requests(
                ids_m, rows15, p15, cap15)),
            "plain_ms": cuda_ms(lambda ids_m=ids_m: fl._route_requests_plain(
                ids_m, rows15, p15, cap15)),
            "eager_ms": eager_ms(lambda ids_m=ids_m: fl.route_requests(
                ids_m, rows15, p15, cap15)),
            "library_ms": cuda_ms(k15_library), "bound_ms": b15,
            "bound_by": by15, "vectors": s15, "ids": g15}
    main15 = k15["batched"]
    record("route_requests", "gigl_tpu_torch/csrc/route.cu",
           "gigl_tpu/parallel/feature_lookup.py:48", 0.0, main15["ms"],
           main15["plain_ms"],
           nbytes=p15 * (g15 * 4 + g15 * 9 + p15 * cap15 * 4),
           nops=p15 * g15 * 12, library_ms=main15["library_ms"],
           library_call="torch.sort(stable=True) of the owners (offset by "
                        "P a vector), counts by scatter_add_, positions "
                        "scattered back",
           vectors=p15, ids=g15, shards=p15, capacity=cap15,
           rows_per_shard=rows15, eager_ms=main15["eager_ms"],
           modes={"single": k15["single"]})

    # -- K16 at the union gather's [P, C, D + 1] fp32 answers, and its mode
    # over the widest drawn neighbor rows (int32). bytes: owner / pos / ok
    # read, each answered row read once, each output row written once.
    def k16_case(case):
        back, owner, pos, ok = case
        got_ = fl.unroute_rows(back, owner, pos, ok)
        check(torch.equal(got_, fl._unroute_plain(back, owner, pos, ok)),
              "K16 unroute_rows is not bit-equal")
        c_ = back.shape[1]
        flat = back.reshape(back.shape[0] * c_, -1)
        idx = owner.long() * c_ + pos.clamp(max=c_ - 1).long()
        zero = torch.zeros((), dtype=back.dtype, device=dev)
        row_b = flat.shape[1] * back.element_size()
        g_ = owner.numel()
        return {"ms": cuda_ms(lambda: fl.unroute_rows(back, owner, pos, ok)),
                "plain_ms": cuda_ms(
                    lambda: fl._unroute_plain(back, owner, pos, ok)),
                "library_ms": cuda_ms(lambda: torch.where(
                    ok[:, None], flat.index_select(0, idx), zero)),
                "nbytes": g_ * 9 + int(ok.sum()) * row_b + g_ * row_b,
                "rows": g_, "row_bytes": row_b, "answers": list(back.shape),
                "dtype": str(back.dtype).replace("torch.", "")}

    fp_cases = [u_ for u_ in unroutes if u_[0].dtype == torch.float32]
    int_cases = [u_ for u_ in unroutes if u_[0].dtype == torch.int32]
    u16 = k16_case(max(fp_cases, key=lambda u_: u_[0].numel()))
    record("unroute_rows", "gigl_tpu_torch/csrc/route.cu",
           "gigl_tpu/parallel/feature_lookup.py:83", 0.0, u16["ms"],
           u16["plain_ms"], nbytes=u16["nbytes"], nops=0,
           library_ms=u16["library_ms"],
           library_call="index_select of the flattened answers by owner * C "
                        "+ pos (computed beforehand), then where(ok)",
           **{k_: v_ for k_, v_ in u16.items()
              if k_ in ("rows", "row_bytes", "answers", "dtype")})
    u16i = k16_case(max(int_cases, key=lambda u_: u_[0].numel()))
    u16i["bound_ms"] = bound_ms(u16i.pop("nbytes"), 0)[0]
    add_mode("unroute_rows", "int32_draw", u16i)

    # -- K1's row-offset mode at the step's largest owner-side draw on
    # shard 0 (its local rows are the global rows, so the old mode over
    # the global CSR gives the same bits on the same frontier)
    ip1, ix1, fr1, fan1, seed1, hop1, off1 = max(
        (d_ for d_ in draws if d_[6] == 0), key=lambda d_: d_[2].numel())
    csr = dg.message_csr
    got1 = sample_uniform(ip1, ix1, fr1, fan1, seed1, hop1, row_offset=off1)
    old1 = sample_uniform(csr.indptr, csr.indices, fr1, fan1, seed1, hop1)
    twin1 = _sample_uniform_plain(ip1, ix1, fr1, fan1, seed1, hop1, off1)
    check(all(torch.equal(a_, b_) and torch.equal(a_, c_)
              for a_, b_, c_ in zip(got1, old1, twin1)),
          "K1's row-offset mode differs from its twin or the plain mode")
    m1 = fr1.numel()
    add_mode("sample_uniform", "row_offset", {
        "err": 0.0, "frontier": list(fr1.shape), "fanout": fan1,
        "ms": cuda_ms(lambda: sample_uniform(ip1, ix1, fr1, fan1, seed1,
                                             hop1, row_offset=off1)),
        "ms_plain_mode_same_rows": cuda_ms(lambda: sample_uniform(
            csr.indptr, csr.indices, fr1, fan1, seed1, hop1)),
        "plain_ms": cuda_ms(lambda: _sample_uniform_plain(
            ip1, ix1, fr1, fan1, seed1, hop1, off1)),
        "bound_ms": bound_ms(m1 * 4 + unique(fr1) * 8
                             + unique(got1[2][got1[1]]) * 4 + m1 * fan1 * 9,
                             m1 * fan1 * 24)[0]})

    # -- K17: shard 0's fold of its P blocks ([P, Q_l, C_l] fp32 in ring
    # order, one launch) and their backward (one launch). bytes: S read
    # (and dS written), the blocks' column ids, masks and logQ, the row
    # data and the running state.
    check(len(folds) == shards and len(bwds) == shards,
          f"K17: {len(folds)} folds and {len(bwds)} backward calls in a "
          f"step, not one each a shard ({shards})")
    sc, rws, cls, own = folds[0]
    check(sc.dim() == 3 and sc.shape[0] == shards,
          f"K17: the step folded {tuple(sc.shape)}, not a shard's "
          f"{shards} blocks in one call")
    p17, ql, cl = sc.shape
    fresh = (torch.full((ql,), sr.FMIN, device=dev),
             torch.zeros(ql, device=dev), torch.zeros(ql, device=dev))
    got_state = [t_.clone() for t_ in fresh]
    want_state = [t_.clone() for t_ in fresh]
    sr.ring_fold(sc, rws, cls, own, *got_state)
    sr._ring_fold_plain(sc, rws, cls, own, *want_state)
    for g_, w_ in zip(got_state, want_state):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=0)
    fold_err = max(float((g_ - w_).abs().max())
                   for g_, w_ in zip(got_state, want_state))
    bsc, brw, bcl, bown, lse, gr = bwds[0]
    ds_k = sr.ring_block_bwd(bsc, brw, bcl, bown, lse, gr)
    ds_p = sr._ring_block_bwd_plain(bsc, brw, bcl, bown, lse, gr)
    ds_scale = float(ds_p.abs().max())
    ds_err = float((ds_k - ds_p).abs().max())
    check(ds_err <= 1e-5 * ds_scale,
          f"K17 backward error {ds_err} > 1e-5 * {ds_scale}")
    # the masked scores of all P blocks side by side: the yardstick's input
    v_all = torch.cat([sr._masked_block_plain(
        bsc[t_], brw, sr._block_cols(bcl, t_), bown and t_ == 0)[0]
        for t_ in range(p17)], 1)
    work = [t_.clone() for t_ in fresh]
    fold_ms = cuda_ms(lambda: sr.ring_fold(sc, rws, cls, own, *work))
    bwd_ms = cuda_ms(lambda: sr.ring_block_bwd(bsc, brw, bcl, bown, lse, gr))
    sc0, cls0 = sc[0].contiguous(), sr._block_cols(cls, 0)
    fold_one_ms = cuda_ms(lambda: sr.ring_fold(sc0, rws, cls0, own, *work))
    plain_fold_ms = cuda_ms(lambda: sr._ring_fold_plain(sc, rws, cls, own,
                                                        *work))
    plain_bwd_ms = cuda_ms(lambda: sr._ring_block_bwd_plain(
        bsc, brw, bcl, bown, lse, gr))
    v_lib = v_all.detach().clone().requires_grad_()
    lib_fold = cuda_ms(lambda: torch.logsumexp(v_all, 1))
    # the P blocks' logsumexp and its gradient (the softmax), as K5's
    # yardstick takes cross_entropy and its gradient
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        torch.logsumexp(v_lib, 1).sum(), v_lib))
    cols_b = p17 * cl * 13
    rows_b = ql * 12
    record("ring_retrieval", "gigl_tpu_torch/csrc/ring_retrieval.cu",
           "gigl_tpu/losses/sharded_retrieval.py:40",
           max(fold_err, ds_err), fold_ms + bwd_ms,
           plain_fold_ms + plain_bwd_ms,
           nbytes=(p17 * ql * cl * 4 + cols_b + rows_b + ql * 24)
           + (p17 * ql * cl * 8 + cols_b + rows_b + ql * 8),
           nops=p17 * ql * cl * 22, library_ms=lib_ms,
           library_call="torch.logsumexp over the P masked blocks side by "
                        "side and its gradient (autograd.grad)",
           fold_ms=fold_ms, bwd_ms=bwd_ms, fold_one_block_ms=fold_one_ms,
           plain_fold_ms=plain_fold_ms, plain_bwd_ms=plain_bwd_ms,
           library_fold_ms=lib_fold, blocks=[p17, ql, cl],
           ds_scale=ds_scale, folds_per_step=len(folds),
           bwds_per_step=len(bwds),
           eager_ms=eager_ms(lambda: sr.ring_fold(sc, rws, cls, own, *work)))
    a2a_union = fp_cases[0][0].nbytes * shards
    del routes, unroutes, draws, folds, bwds, fp_cases, int_cases, work
    del v_all, v_lib

    # -- the paths: both pools (bf16, the sketch on), then encode_batch
    # over every node
    edges_per_step = (2 * k1 + k1 * k2) * (BATCH + BATCH + R)
    trainer = None
    for path, pool in (("partitioned_train", "per_shard"),
                       ("partitioned_ring_train", "ring")):
        trainer = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        mesh.reset_counts()
        _build.reset_launches()
        t0 = time.perf_counter()
        trainer = trainer_for(make_model(), use_cms_correction=True,
                              global_candidate_pool=pool == "ring")
        state = trainer.init_state(0)
        gens = [torch.Generator(device=dev).manual_seed(s_)
                for s_ in range(shards)]
        state, warm = trainer.train_steps(state, anchors[:PART_WARMUP], gens)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, losses = trainer.train_steps(
            state, anchors[PART_WARMUP: PART_WARMUP + PART_STEPS], gens)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
        nsteps = PART_WARMUP + PART_STEPS
        counts[path] = (dict(_build.launches), nsteps)
        a2a_per_step = mesh.a2a_bytes / nsteps
        a2a_calls = mesh.a2a_calls / nsteps
        peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
        emit({"phase": "main_path", "path": path, "pool": pool,
              "launches": counts[path][0], "steps": nsteps,
              "seconds": time.perf_counter() - t0})
        want_k = PART_TRAIN_KERNELS + (
            ("ring_retrieval",) if pool == "ring" else ("retrieval_loss",))
        for k in want_k:
            check(counts[path][0][k] > 0, f"{k} was not launched on {path}")
        if pool == "ring":
            check(counts[path][0]["ring_retrieval"] == 2 * shards * nsteps,
                  f"{path}: K17 launched "
                  f"{counts[path][0]['ring_retrieval']} times in {nsteps} "
                  "steps, not a fold and a backward a shard")
        check(trainer.overflow_total == 0,
              f"{path}: {trainer.overflow_total} routed requests dropped")
        total = int(state.cms.total)
        check(total == nsteps * (BATCH + R),
              f"{path}: the sketch counted {total}, not {nsteps} x "
              f"{BATCH + R}")
        losses = losses.float().cpu().numpy()
        check(np.isfinite(losses).all() and np.isfinite(
            warm.float().cpu().numpy()).all(), f"{path}: loss not finite")
        ms_step = train_s / PART_STEPS * 1e3
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            state, _ = trainer.train_steps(
                state, anchors[PART_WARMUP + PART_STEPS:], gens)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t1) * 1e6
        if pool == "per_shard":
            per_shard_trainer = trainer
        emit({"phase": "partitioned_train_throughput", "pool": pool,
              "shards": shards, "steps": PART_STEPS, "ms_per_step": ms_step,
              "edges_per_step": edges_per_step,
              "edges_per_s": edges_per_step / (ms_step / 1e3),
              "launches_per_step": {k_: v_ / nsteps for k_, v_ in
                                    counts[path][0].items() if v_},
              "a2a_bytes_per_step": a2a_per_step,
              "a2a_calls_per_step": a2a_calls,
              "a2a_bytes_union_gather": a2a_union,
              "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
              "sketch_total": total, "overflow_total": trainer.overflow_total,
              "peak_mem_gb": peak_gb,
              "profile": profile_summary(prof, PART_PROFILED, window_us,
                                         ms_step), "card": card})
        del state

    path = "partitioned_encode"
    mesh.reset_counts()
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embs = torch.cat([trainer.encode_batch(
        np.arange(i_, min(i_ + BATCH, N), dtype=np.int32))
        for i_ in range(0, N, BATCH)])
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    n_batches = -(-N // BATCH)
    counts[path] = (dict(_build.launches), n_batches)
    emit({"phase": "main_path", "path": path, "launches": counts[path][0],
          "batches": n_batches, "seconds": enc_s})
    for k in PART_ENCODE_KERNELS:
        check(counts[path][0][k] > 0, f"{k} was not launched on {path}")
    check(embs.shape == (N, OUT) and bool(torch.isfinite(embs).all()),
          f"{path}: embeddings are not finite [{N}, {OUT}]")
    with torch.inference_mode(), plain_kernels():
        ref0 = trainer.encode_batch(np.arange(BATCH, dtype=np.int32))
    err0 = float((embs[:BATCH].float() - ref0.float()).abs().max())
    scale0 = float(ref0.float().abs().max())
    # the same inputs through the same bf16 casts: the kernels and their
    # twins give the same bits here (0.0 measured on the H100)
    check(err0 == 0.0, f"{path}: batch 0 differs from the plain "
          f"recomputation: {err0} (scale {scale0})")
    emit({"phase": "partitioned_encode_throughput", "nodes": N,
          "nodes_per_s": N / enc_s, "ms_per_batch": enc_s / n_batches * 1e3,
          "launches_per_batch": {k_: v_ / n_batches for k_, v_ in
                                 counts[path][0].items() if v_},
          "a2a_bytes_per_batch": mesh.a2a_bytes / n_batches,
          "batch0_max_abs_err": err0, "scale": scale0, "card": card})
    del trainer, embs, pg, mesh
    return counts, per_shard_trainer


def sharded_phases(dev, card, arrays, masks, record, unique, coo_ms,
                   part_trainer):
    """Phase 15 (see the module docstring): the ring halo exchange and the
    graph-sharded full-batch trainer over PART_SHARDS shards on the card, then
    run_partitioned_inference over phase 14's per-shard-pool trainer.
    Returns {path: (launch counts, steps or passes)}."""
    from gigl_tpu_torch.inference.inferencer import (
        InferenceConfig, node_batches, run_partitioned_inference)
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.ops.segment import SegmentIndex, coo_spmm
    from gigl_tpu_torch.parallel import halo
    from gigl_tpu_torch.parallel.mesh import make_mesh
    from gigl_tpu_torch.parallel.partition import shard_features_rowwise
    from gigl_tpu_torch.training import sharded_full_batch as sfb

    src, dst, feats, labels = arrays
    edges = np.stack([src, dst])
    shards = PART_SHARDS
    counts = {}

    # -- the schedule (host build, then the device index)
    t0 = time.perf_counter()
    sched = halo.build_ring_schedule(edges, N, shards)
    build_s = time.perf_counter() - t0
    mesh = make_mesh(shards)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    placed = halo.put_ring_schedule(sched, mesh)
    torch.cuda.synchronize()
    put_s = time.perf_counter() - t0
    bucket_counts = sched.counts.reshape(-1)
    emit({"phase": "sharded_schedule", "shards": shards, "per": sched.per,
          "build_s": build_s, "put_s": put_s,
          "e_max": int(sched.src_local.shape[-1]),
          "bucket_edges": [int(c_) for c_ in bucket_counts]})
    check(int(bucket_counts.sum()) == E,
          "the ring buckets do not hold every edge once")
    check(bool((bucket_counts > 0).all()),
          "an empty bucket on the flagship graph")

    # -- K18 at the largest bucket: forward at D 128 (layer 1) and 256
    # (layer 2), transposed at 256. bytes: the bucket's index (ptr, col, w)
    # read once, each distinct row it reads once, each touched output row
    # read and written once; ops: a multiply-add per edge and value.
    b = int(np.argmax(bucket_counts))
    s_b, k_b = divmod(b, shards)
    c_b = int(bucket_counts[b])
    per = sched.per
    gen = torch.Generator(device=dev).manual_seed(15)
    modes = {}
    for label, width, side in (("fwd_d256", HID, "fwd"),
                               ("fwd_d128", D, "fwd"),
                               ("transposed_d256", HID, "bwd")):
        index = placed.fwd if side == "fwd" else placed.bwd
        ptr, row, col, w = index["sum"][b]
        xb = torch.randn((per, width), generator=gen, device=dev)
        acc0 = torch.randn((per, width), generator=gen, device=dev)
        got = halo.ring_spmm_bucket(xb, acc0.clone(), ptr, row, col, w)
        want = halo._ring_spmm_bucket_plain(xb, acc0.clone(), ptr, row, col,
                                            w)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        check(err <= 1e-5 * scale, f"K18 {label}: error {err} > 1e-5 * "
              f"{scale}")
        again = halo.ring_spmm_bucket(xb, acc0.clone(), ptr, row, col, w)
        check(torch.equal(got, again), f"K18 {label}: not the same bits on "
              f"a repeat launch")
        acc = acc0.clone()
        touched = int((torch.diff(ptr.long()) > 0).sum())
        nbytes = ((per + 1) * 4 + c_b * 8 + unique(col) * width * 4
                  + touched * width * 8)
        adj = torch.sparse_csr_tensor(ptr, col, w, (per, per))
        # the reference's body over the bucket's slots in their order
        order_src = torch.as_tensor(sched.src_local[s_b, k_b, :c_b],
                                    device=dev).long()
        order_dst = torch.as_tensor(sched.dst_local[s_b, k_b, :c_b],
                                    device=dev).long()
        if side == "bwd":
            order_src, order_dst = order_dst, order_src
        w_slot = torch.as_tensor(sched.weight[s_b, k_b, :c_b], device=dev)
        check(float((torch.sparse.mm(adj, xb) + acc0 - want).abs().max())
              <= 1e-5 * scale, f"the sparse.mm yardstick ({label}) differs")
        modes[label] = {
            "err": err, "scale": scale, "width": width,
            "ms": cuda_ms(lambda: halo.ring_spmm_bucket(xb, acc, ptr, row,
                                                        col, w)),
            "plain_ms": cuda_ms(lambda: halo._ring_spmm_bucket_plain(
                xb, acc, ptr, row, col, w)),
            "bound_ms": bound_ms(nbytes, 2 * c_b * width)[0],
            "library_ms": cuda_ms(lambda: acc.add_(torch.sparse.mm(adj,
                                                                   xb))),
            "index_add_ms": cuda_ms(lambda: acc.index_add_(
                0, order_dst, xb[order_src] * w_slot[:, None])),
            "eager_ms": eager_ms(lambda: halo.ring_spmm_bucket(
                xb, acc, ptr, row, col, w)),
            "nbytes": nbytes, "nops": 2 * c_b * width,
            "rows_touched": touched, "distinct_rows_read": unique(col)}
        del xb, acc0, acc, got, want, again, adj
    main_mode = modes["fwd_d256"]
    record("ring_spmm", "gigl_tpu_torch/csrc/ring_spmm.cu",
           "gigl_tpu/parallel/halo.py:143",
           max(v["err"] for v in modes.values()), main_mode["ms"],
           main_mode["plain_ms"], nbytes=main_mode["nbytes"],
           nops=main_mode["nops"], library_ms=main_mode["library_ms"],
           library_call="acc.add_(torch.sparse.mm(bucket CSR [per, per], "
                        "block)) (the CSR built beforehand); index_add_ms: "
                        "acc.index_add_(0, dst, blk[src] * w[:, None]) over "
                        "the schedule's slots, the reference's body",
           index_add_ms=main_mode["index_add_ms"], bucket=[s_b, k_b],
           edges=c_b, rows=per, eager_ms=main_mode["eager_ms"],
           modes={m_: {k_: v_ for k_, v_ in v.items()
                       if k_ not in ("nbytes", "nops")}
                  for m_, v in modes.items()})

    # -- the whole ring (sum, mean) at PART_SHARDS shards against one shard
    # (one bucket) and against coo_spmm (K8) on the same graph
    x = shard_features_rowwise(feats, mesh)
    mesh1 = make_mesh(1)
    placed1 = halo.put_ring_schedule(halo.build_ring_schedule(edges, N, 1),
                                     mesh1)
    x1 = shard_features_rowwise(feats, mesh1)
    src_t = torch.as_tensor(src.astype(np.int32), device=dev)
    dst_t = torch.as_tensor(dst.astype(np.int32), device=dev)
    index = SegmentIndex.from_ids(dst, N, dev)
    ring = {}
    for reduce in ("sum", "mean"):
        _build.reset_launches()
        got = halo.ring_spmm(x, placed, mesh, reduce=reduce)[:N]
        torch.cuda.synchronize()
        check(_build.launches["ring_spmm"] == shards * shards,
              f"the {reduce} ring launched {_build.launches['ring_spmm']} "
              f"kernels, not {shards * shards}")
        one = halo.ring_spmm(x1, placed1, mesh1, reduce=reduce)[:N]
        coo = coo_spmm(src_t, dst_t, x1[:N], N, reduce=reduce, index=index)
        scale = float(coo.abs().max())
        e1 = float((got - one).abs().max())
        e2 = float((got - coo).abs().max())
        check(max(e1, e2) <= 1e-5 * scale, f"the {reduce} ring differs: "
              f"{e1} from one shard, {e2} from coo_spmm (scale {scale})")
        ring[reduce] = {
            "err_vs_one_shard": e1, "err_vs_coo_spmm": e2, "scale": scale,
            "ms": cuda_ms(lambda: halo.ring_spmm(x, placed, mesh,
                                                 reduce=reduce), reps=5),
            "eager_ms": eager_ms(lambda: halo.ring_spmm(x, placed, mesh,
                                                        reduce=reduce)),
            "one_shard_ms": cuda_ms(lambda: halo.ring_spmm(
                x1, placed1, mesh1, reduce=reduce), reps=5),
            "coo_spmm_ms": cuda_ms(lambda: coo_spmm(
                src_t, dst_t, x1[:N], N, reduce=reduce, index=index),
                reps=5)}
    emit({"phase": "sharded_ring_checks", "shards": shards, "width": D,
          **ring, "card": card})
    del x, x1, mesh1, placed1, got, one, coo, placed, index

    # -- per model: one step against the plain twins (the loss, every
    # parameter's gradient and the gradient into layer 2's input), then the
    # path with the launch counts reset just before and read just after
    train, val, test = masks
    kw = dict(hid_dim=HID, out_dim=C, num_layers=2)
    for conv in ("gcn", "graphsage"):
        path = f"sharded_{conv}"
        t_ = sfb.ShardedFullBatchTrainer(
            edges, feats, labels, train, val, test, mesh,
            sfb.ShardedFullBatchConfig(conv=conv, **kw),
            optimizer_args={"learning_rate": "1e-2"})
        t_.init_state(0)

        def keep(a, k):
            if a[0].requires_grad:
                a[0].retain_grad()
            return a[0]

        with spy(sfb, "ring_spmm", keep) as inputs:
            vs = step_vs_plain(t_.model, t_.loss, _build.launches)
        check(len(inputs) == 4, "the step did not run two rings")
        g_k, g_p = inputs[1].grad, inputs[3].grad
        g_scale = float(g_p.abs().max())
        g_err = float((g_k - g_p).abs().max()) / g_scale
        emit({"phase": "sharded_step_vs_plain", "model": conv, **vs,
              "layer2_input_grad_err_rel_to_scale": g_err})
        check(vs["loss_rel_err"] <= 1e-5,
              f"{path}: loss differs from the plain step: {vs}")
        check(max(vs["max_grad_err_rel_to_scale"], g_err) <= 1e-4,
              f"{path}: a gradient differs from the plain step: {vs}, "
              f"layer 2's input {g_err}")
        del t_, inputs, g_k, g_p

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        _build.reset_launches()
        t0 = time.perf_counter()
        trainer = sfb.ShardedFullBatchTrainer(
            edges, feats, labels, train, val, test, mesh,
            sfb.ShardedFullBatchConfig(conv=conv, **kw),
            optimizer_args={"learning_rate": "1e-2"})
        state = trainer.init_state(0)
        for _ in range(FB_WARMUP):
            state, _ = trainer.train_step(state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses = []
        for _ in range(FB_STEPS):
            state, loss = trainer.train_step(state)
            losses.append(loss)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t1) / FB_STEPS
        nsteps = FB_WARMUP + FB_STEPS
        counts[path] = (dict(_build.launches), nsteps)
        emit({"phase": "main_path", "path": path,
              "launches": counts[path][0], "steps": nsteps,
              "seconds": time.perf_counter() - t0})
        per_step = counts[path][0]["ring_spmm"] / nsteps
        check(per_step == 3 * shards * shards,
              f"{path}: {per_step} K18 launches a step, not "
              f"{3 * shards * shards} (two rings forward, one backward)")
        losses = torch.stack(losses).float().cpu().numpy()
        check(np.isfinite(losses).all(), f"{path}: loss not finite")
        first, last = float(losses[:5].mean()), float(losses[-5:].mean())
        check(last < first, f"{path}: loss did not fall: {first} -> {last}")
        peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(FB_PROFILED):
                state, _ = trainer.train_step(state)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t1) * 1e6
        acc = trainer.accuracy("val")
        check(0.0 <= acc <= 1.0, f"{path}: accuracy {acc}")
        logits = trainer.logits()
        check(logits.shape == (N, C) and bool(torch.isfinite(logits).all()),
              f"{path}: logits are not finite [{N}, {C}]")
        emit({"phase": "sharded_train_throughput", "model": conv,
              "shards": shards, "steps": FB_STEPS,
              "ms_per_step": step_s * 1e3,
              "edges_per_step": 2 * E, "edges_per_s": 2 * E / step_s,
              "ring_spmm_launches_per_step": per_step,
              "coo_full_batch_graphsage_ms_per_step": coo_ms["graphsage"],
              "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
              "loss_first5": first, "loss_last5": last, "val_accuracy": acc,
              "peak_mem_gb": peak_gb,
              "profile": profile_summary(prof, FB_PROFILED, window_us,
                                         step_s * 1e3), "card": card})
        del trainer, state, logits

    # -- run_partitioned_inference over phase 14's per-shard-pool trainer:
    # every node into an in-memory exporter, each row against encode_batch
    path = "partitioned_inference"
    sink = Sink()
    cfg = InferenceConfig(batch_size=BATCH)
    part_trainer.mesh.reset_counts()
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    total = run_partitioned_inference(part_trainer, N, sink, cfg)
    inf_s = time.perf_counter() - t0
    n_batches = -(-N // BATCH)
    counts[path] = (dict(_build.launches), n_batches)
    emit({"phase": "main_path", "path": path, "launches": counts[path][0],
          "batches": n_batches, "seconds": inf_s})
    for k in PART_ENCODE_KERNELS:
        check(counts[path][0][k] > 0, f"{k} was not launched on {path}")
    check(total == N, f"{path}: {total} rows exported, not {N}")
    embs = sink.table(N, OUT, path)
    worst = 0.0
    for ids, valid in node_batches(N, cfg):
        want = part_trainer.encode_batch(ids).float().cpu().numpy()[:valid]
        worst = max(worst, float(np.abs(embs[ids[:valid]] - want).max()))
    check(worst == 0.0, f"{path}: exported rows differ from encode_batch's "
          f"by {worst}")
    emit({"phase": "partitioned_inference_throughput", "nodes": N,
          "nodes_per_s": N / inf_s, "ms_per_batch": inf_s / n_batches * 1e3,
          "max_abs_err_vs_encode_batch": worst, "card": card})
    del mesh, sink, embs
    return counts


def weighted_phases(dev, card, arrays, record, add_mode, unique, make_model,
                    opt_args, base_cfg, uniform_ms_step, typed_ctx, rel_err):
    """Phase 16 (see the module docstring): the weighted and top-k draws.
    K19 sample_weighted and K2's weighted mode against their twins at the
    path's shapes, then the weighted / top-k paths, each with the launch
    counts reset just before and read just after: every path launches K19
    and K1 only for the label-edge draws the reference makes uniformly
    (the positives), never for a message-graph draw. Returns {path:
    (launch counts, steps or passes)}."""
    from gigl_tpu_torch.graph.csr import HeteroGraph
    from gigl_tpu_torch.inference.inferencer import (
        InferenceConfig, run_inference)
    from gigl_tpu_torch.models.encoders import GNNEncoder
    from gigl_tpu_torch.models.link_prediction import (
        HeteroLinkPredictionGNN, LinkPredictionDecoder, LinkPredictionGNN)
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.ops.hopcache import (
        _neighbor_cache_plain, build_neighbor_cache)
    from gigl_tpu_torch.ops.quantized import QuantizedTable
    from gigl_tpu_torch.parallel.mesh import make_mesh
    from gigl_tpu_torch.sampling.neighbor_sampler import (
        DeviceCSR, _sample_weighted_plain, sample_weighted, window_scores)
    from gigl_tpu_torch.training.dataset import DeviceGraph
    from gigl_tpu_torch.training.dist_sampled import (
        PartitionedGraph, PartitionedNALPTrainer, _shard_csr)
    from gigl_tpu_torch.training.hetero_dataset import HeteroDeviceGraph
    from gigl_tpu_torch.training.hetero_trainer import (
        HeteroNALPTrainer, HeteroNALPTrainerConfig)
    from gigl_tpu_torch.training.trainer import (
        NALPTrainer, NALPTrainerConfig)

    src, dst, x_np = arrays
    k1, k2 = FANOUTS
    counts = {}

    # -- the weighted graph: from_hetero sorts each row by weight ------------
    rng = np.random.default_rng(W_SEED)
    ef = rng.random((E, W_DE), dtype=np.float32)
    graph = HeteroGraph.homogeneous(src=src, dst=dst, num_nodes=N,
                                    node_features=x_np, edge_features=ef)
    csr_h = graph.csr(graph.metadata.edge_types[0], anchor="dst")
    t0 = time.perf_counter()
    row_of = np.repeat(np.arange(N), np.diff(csr_h.indptr))
    np.lexsort((-ef[csr_h.edge_ids, 0], row_of))
    sort_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dg = DeviceGraph.from_hetero(graph, supervision_edges=np.stack([src, dst]),
                                 sampling_weight_index=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    csr = dg.message_csr
    w_dev = csr.edge_weights
    same_row = torch.as_tensor(row_of[1:] == row_of[:-1], device=dev)
    check(bool(((w_dev[1:] <= w_dev[:-1]) | ~same_row).all()),
          "a CSR row is not sorted by descending weight")
    check(torch.equal(w_dev, dg.edge_features[:, 0]),
          "the weights are not the edge rows' column 0 in slot order")
    emit({"phase": "weighted_graph", "edge_features": [E, W_DE],
          "host_sort_s": sort_s, "from_hetero_s": build_s,
          "weight_bytes": w_dev.nbytes})

    # -- K19 against its twin (bit-equal) at the path's shapes --------------
    def k19_case(label, csr_, frontier, fanout, method, seed, hop,
                 row_offset=None):
        args = (csr_.indptr, csr_.indices, csr_.edge_weights, frontier,
                fanout, W_WINDOW, method, seed, hop, row_offset)
        got = sample_weighted(*args)
        want = _sample_weighted_plain(*args)
        check(all(torch.equal(g_, w_) for g_, w_ in zip(got, want)),
              f"K19 sample_weighted ({label}) is not bit-equal to its twin")
        f = frontier.reshape(-1).long()
        if row_offset is not None:
            f = (f - row_offset).clamp(0, csr_.indptr.shape[0] - 2)
        start = csr_.indptr[f].long()
        deg = csr_.indptr[f + 1].long() - start
        scores = window_scores(csr_.edge_weights, start, deg,
                               frontier.reshape(-1), seed, hop, method,
                               W_WINDOW)
        m = f.numel()
        rows_u = torch.unique(f)
        deg_u = (csr_.indptr[rows_u + 1] - csr_.indptr[rows_u]).long()
        valid = int(deg.clamp(max=W_WINDOW).sum())
        # bytes: the frontier, each distinct row's indptr pair and window
        # weights read once, each distinct drawn CSR slot read once, ids +
        # mask + slots written; ops: the hash and two logs a valid slot
        # (weighted; one log for top_k) and one compare a window slot.
        nbytes = (m * 4 + rows_u.numel() * 8
                  + int(deg_u.clamp(max=W_WINDOW).sum()) * 4
                  + unique(got[2][got[1]]) * 4 + m * fanout * 9)
        nops = valid * (40 if method == "weighted" else 14) + m * W_WINDOW
        return {"frontier": list(frontier.shape), "fanout": fanout,
                "method": method, "ms": cuda_ms(lambda: sample_weighted(
                    *args)),
                "plain_ms": cuda_ms(lambda: _sample_weighted_plain(*args),
                                    reps=3),
                "library_ms": cuda_ms(lambda: torch.topk(scores, fanout)),
                "eager_ms": eager_ms(lambda: sample_weighted(*args)),
                "bound_ms": bound_ms(nbytes, nops)[0], "nbytes": nbytes,
                "nops": nops, "valid_window_slots": valid,
                "row_offset": row_offset}

    ids_all = torch.arange(N, dtype=torch.int32, device=dev)
    k19 = {}
    for method in ("weighted", "top_k"):
        k19[f"all_nodes_{method}"] = k19_case(
            f"all nodes, {method}", csr, ids_all, k1, method, 0, 1)
    hop1 = torch.arange(3 * BATCH, dtype=torch.int32, device=dev) % N
    k19["live_hop1"] = k19_case("live hop 1", csr, hop1, k1, "weighted", 0, 1)
    ids1, mask1, _ = sample_weighted(csr.indptr, csr.indices, w_dev, hop1, k1,
                                     W_WINDOW, "weighted", 0, 1)
    hop2 = torch.where(mask1, ids1, 0)
    k19["live_hop2"] = k19_case("live hop 2", csr, hop2, k2, "weighted", 0, 2)
    hrng = np.random.default_rng(W_SEED + 1)
    hub_ip = (np.arange(W_HUB_ROWS + 1) * W_HUB_DEG).astype(np.int32)
    hub = DeviceCSR(
        torch.as_tensor(hub_ip, device=dev),
        torch.as_tensor(hrng.integers(0, N, W_HUB_ROWS * W_HUB_DEG).astype(
            np.int32), device=dev),
        torch.as_tensor(hrng.integers(0, 4, W_HUB_ROWS * W_HUB_DEG).astype(
            np.float32), device=dev))
    hub_ids = torch.arange(W_HUB_ROWS, dtype=torch.int32, device=dev)
    for method in ("weighted", "top_k"):
        k19[f"hub_{method}"] = k19_case(f"hub, {method}", hub, hub_ids, k1,
                                        method, 0, 1)
    # the row-offset mode on phase 14's layout: shard 1's block of the
    # 4-way row partition, asked for the hop-2 ids it owns
    rows = -(-N // PART_SHARDS)
    ip_s, ix_s, w_s = _shard_csr(csr.indptr.cpu().numpy(),
                                 csr.indices.cpu().numpy(), PART_SHARDS, rows,
                                 weights=w_dev.cpu().numpy())
    shard1 = DeviceCSR(torch.as_tensor(ip_s[1], device=dev),
                       torch.as_tensor(ix_s[1], device=dev),
                       torch.as_tensor(w_s[1], device=dev))
    flat2 = hop2.reshape(-1)
    owned = flat2[(flat2 >= rows) & (flat2 < 2 * rows)].contiguous()
    k19["row_offset"] = k19_case("row offset", shard1, owned, k2, "weighted",
                                 0, 2, row_offset=rows)
    main = k19["all_nodes_weighted"]
    record("sample_weighted", "gigl_tpu_torch/csrc/sample_weighted.cu",
           "gigl_tpu/sampling/neighbor_sampler.py:96", 0.0, main["ms"],
           main["plain_ms"], nbytes=main["nbytes"], nops=main["nops"],
           library_ms=main["library_ms"],
           library_call="torch.topk(scores, fanout) over the [m, 128] score "
                        "matrix built beforehand",
           window=W_WINDOW, frontier=main["frontier"], fanout=k1,
           eager_ms=main["eager_ms"],
           modes={m_: {k_: v_ for k_, v_ in v.items()
                       if k_ not in ("nbytes", "nops")}
                  for m_, v in k19.items() if m_ != "all_nodes_weighted"})

    # -- K2's weighted mode (mean of 10 rows), fp32 and int8, beside the
    # uniform mode in the same call
    x = dg.node_features
    xq = QuantizedTable.quantize(x_np, device=dev)
    out2 = torch.empty((N, D), dtype=torch.float32, device=dev)
    plain2 = torch.empty_like(out2)
    d_ids, d_mask, d_slots = _sample_weighted_plain(
        csr.indptr, csr.indices, w_dev, ids_all, k2, W_WINDOW, "weighted", 0,
        2)
    deg_all = torch.diff(csr.indptr.long())
    window_w = int(deg_all.clamp(max=W_WINDOW).sum())
    for label, feats, method in (("weighted_fp32", x, "weighted"),
                                 ("top_k_fp32", x, "top_k"),
                                 ("weighted_int8", xq, "weighted")):
        def k2w():
            return build_neighbor_cache(csr, feats, fanout=k2, seed=0,
                                        hop_key=2, agg="mean", method=method,
                                        out=out2)

        def k2w_plain():
            return _neighbor_cache_plain(csr, feats, k2, 0, 2, "mean", None,
                                         plain2, method=method)

        k2w()
        k2w_plain()
        scale2 = float(plain2.abs().max())
        err2 = float((out2 - plain2).abs().max())
        # fp32 means of <= 10 rows in another order
        check(err2 <= 1e-5 * scale2, f"K2 {label} error {err2} > 1e-5 * "
              f"{scale2}")
        row_b = D + 4 if label.endswith("int8") else D * 4
        nbytes = ((N + 1) * 4 + window_w * 4 + unique(d_slots[d_mask]) * 4
                  + unique(d_ids[d_mask]) * row_b + N * D * 4)
        add_mode("build_neighbor_cache", label, {
            "err": err2, "ms": cuda_ms(k2w),
            "ms_uniform_same_call": cuda_ms(lambda: build_neighbor_cache(
                csr, feats, fanout=k2, seed=0, hop_key=2, agg="mean",
                out=out2)),
            "plain_ms": cuda_ms(k2w_plain, reps=3), "eager_ms": eager_ms(k2w),
            "bound_ms": bound_ms(nbytes, int(d_mask.sum()) * D * 2 + N * D
                                 + window_w * 40)[0]})
    del xq, out2, plain2, d_ids, d_mask, d_slots

    # -- the paths ---------------------------------------------------------
    n_anchor = W_WARMUP + W_STEPS + W_PROFILED
    anchors = (np.arange(BATCH * n_anchor) % N).astype(np.int32).reshape(
        n_anchor, BATCH)
    a0 = torch.as_tensor(anchors[0], device=dev)
    cfg_tab = dataclasses.replace(base_cfg, sampling_method="weighted")
    cfg_live = dataclasses.replace(base_cfg, sampling_method="weighted",
                                   cached_hop=False, fused_cache=False)
    edges_per_step = (2 * k1 + k1 * k2) * (BATCH + BATCH + R)

    for path, cfg_ in (("weighted_tabularized_train", cfg_tab),
                       ("weighted_live_train", cfg_live)):
        # one step against the same step through the plain versions (a
        # separate trainer: these launches are not the path's)
        chk = NALPTrainer(make_model(), dg, cfg_, optimizer_args=opt_args,
                          device=dev)
        chk.init_state(0, batch_size=BATCH)
        vs = step_vs_plain(chk.model.encoder,
                           lambda: chk.loss(chk.sample_batch(a0, 0)),
                           _build.launches)
        emit({"phase": "weighted_step_vs_plain", "path": path, **vs})
        # bf16, as phase 6's step
        check(vs["loss_rel_err"] <= 1e-2,
              f"{path}: loss differs from the plain step: {vs}")
        check(vs["max_grad_err_rel_to_scale"] <= 5e-2,
              f"{path}: a gradient differs from the plain step: {vs}")
        del chk
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        _build.reset_launches()
        t0 = time.perf_counter()
        tr = NALPTrainer(make_model(), dg, cfg_, optimizer_args=opt_args,
                         device=dev)
        torch.cuda.synchronize()
        refresh_ms = (time.perf_counter() - t0) * 1e3
        at_init = dict(_build.launches)
        state = tr.init_state(0, batch_size=BATCH)
        gen = torch.Generator(device=dev).manual_seed(1)
        state, warm = tr.train_steps(state, anchors[:W_WARMUP], gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, losses = tr.train_steps(
            state, anchors[W_WARMUP: W_WARMUP + W_STEPS], gen)
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t1) / W_STEPS * 1e3
        nsteps = W_WARMUP + W_STEPS
        c_ = dict(_build.launches)
        tabular = cfg_.cached_hop
        # a refresh draws the fanout-15 table (K19) and the cache (K2); a
        # live step draws each encode group's two hops (K19); K1 draws one
        # positive a step from the supervision CSR, as the reference does
        k19_init, k19_step = (1, 0) if tabular else (0, 6)
        check(at_init["sample_weighted"] == k19_init
              and at_init["build_neighbor_cache"] == int(tabular),
              f"{path}: the refresh made {at_init['sample_weighted']} K19 "
              f"and {at_init['build_neighbor_cache']} K2 launches")
        check(c_["sample_weighted"] == k19_init + k19_step * nsteps,
              f"{path}: {c_['sample_weighted']} K19 launches, not "
              f"{k19_init} + {k19_step} a step")
        check(c_["sample_uniform"] == nsteps, f"{path}: "
              f"{c_['sample_uniform']} K1 launches, not one a step (the "
              "positives): a message draw fell back to the uniform draw")
        kernels = W_TRAIN_KERNELS if tabular else tuple(
            k_ for k_ in W_TRAIN_KERNELS if k_ != "build_neighbor_cache")
        for k_ in kernels:
            check(c_[k_] > 0, f"{k_} was not launched on {path}")
        losses = losses.float().cpu().numpy()
        check(np.isfinite(losses).all() and np.isfinite(
            warm.float().cpu().numpy()).all(), f"{path}: loss not finite")
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            state, _ = tr.train_steps(state, anchors[W_WARMUP + W_STEPS:],
                                      gen)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t1) * 1e6
        row = {"steps": W_STEPS, "ms_per_step": ms_step,
               "uniform_ms_per_step_phase6": uniform_ms_step,
               "edges_per_step": edges_per_step,
               "edges_per_s": edges_per_step / (ms_step / 1e3),
               "refresh_ms": refresh_ms,
               "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
               "peak_mem_gb": (torch.cuda.max_memory_allocated() - base_mem)
               / 2**30,
               "profile": profile_summary(prof, W_PROFILED, window_us,
                                          ms_step), "card": card}
        if tabular:
            # run_inference over every node: the export checked, batch 0
            # against the plain versions
            sink = Sink()
            t1 = time.perf_counter()
            total = run_inference(tr, N, sink,
                                  InferenceConfig(batch_size=BATCH),
                                  device=dev)
            torch.cuda.synchronize()
            inf_s = time.perf_counter() - t1
            c_ = dict(_build.launches)
            ids_ = np.concatenate(sink.ids)
            embs = np.concatenate(sink.embs)
            check(total == N and np.array_equal(np.sort(ids_), np.arange(N)),
                  f"{path}: the export is not every node exactly once")
            check(embs.shape == (N, OUT) and np.isfinite(embs).all(),
                  f"{path}: embeddings are not finite [N, {OUT}]")
            check(c_["sample_weighted"] == k19_init
                  and c_["sample_uniform"] == nsteps + W_PROFILED,
                  f"{path}: run_inference drew through K19 or K1")
            with torch.inference_mode(), plain_kernels():
                ref0 = tr.encode_batch(np.arange(BATCH, dtype=np.int32))
            row["inference_batch0_err"] = rel_err(
                torch.as_tensor(embs[:BATCH]), ref0.float().cpu(),
                f"{path}: run_inference batch 0 vs plain")
            row["inference_nodes_per_s"] = N / inf_s
            row["inference_ms_per_batch"] = inf_s / -(-N // BATCH) * 1e3
        counts[path] = (c_, nsteps)
        emit({"phase": "main_path", "path": path, "launches": c_,
              "steps": nsteps, "launches_at_refresh": at_init})
        emit({"phase": "weighted_train_throughput", "path": path, **row})
        del tr, state

    # -- the host cost of the draw: the weighted and the uniform step over
    # the same graph in turns (W U U W), tabularized and live, since host
    # clocks drift between phases
    turns = {}
    for mode, cfg_w, cfg_u in (("tabularized", cfg_tab, base_cfg),
                               ("live", cfg_live, dataclasses.replace(
                                   base_cfg, cached_hop=False,
                                   fused_cache=False))):
        pair = {}
        for name_, cfg_ in (("weighted", cfg_w), ("uniform", cfg_u)):
            tr = NALPTrainer(make_model(), dg, cfg_, optimizer_args=opt_args,
                             device=dev)
            st = tr.init_state(0, batch_size=BATCH)
            gen = torch.Generator(device=dev).manual_seed(1)
            st, _ = tr.train_steps(st, anchors[:W_WARMUP], gen)
            pair[name_] = [tr, st, gen, []]
        for name_ in ("weighted", "uniform", "uniform", "weighted"):
            tr, st, gen, times = pair[name_]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = tr.train_steps(st, anchors[W_WARMUP: W_WARMUP
                                               + W_AB_STEPS], gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / W_AB_STEPS * 1e3)
            pair[name_][1] = st
        turns[mode] = {n_: v_[3] for n_, v_ in pair.items()}
        del pair
    emit({"phase": "weighted_vs_uniform_turns", "order": "W U U W",
          "steps_per_turn": W_AB_STEPS, "ms_per_step": turns, "card": card})

    # -- top_k: the same refresh and run_inference -------------------------
    path = "top_k_tabularized_inference"
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = NALPTrainer(make_model(), dg,
                     dataclasses.replace(base_cfg, sampling_method="top_k"),
                     device=dev)
    torch.cuda.synchronize()
    refresh_ms = (time.perf_counter() - t0) * 1e3
    tr.init_params(0)
    sink = Sink()
    t0 = time.perf_counter()
    total = run_inference(tr, N, sink, InferenceConfig(batch_size=BATCH),
                          device=dev)
    torch.cuda.synchronize()
    inf_s = time.perf_counter() - t0
    c_ = dict(_build.launches)
    n_batches = -(-N // BATCH)
    counts[path] = (c_, n_batches)
    emit({"phase": "main_path", "path": path, "launches": c_,
          "batches": n_batches})
    check(c_["sample_weighted"] == 1 and c_["build_neighbor_cache"] == 1
          and c_["sample_uniform"] == 0,
          f"{path}: the refresh did not draw through K19 and K2 alone: {c_}")
    ids_ = np.concatenate(sink.ids)
    embs = np.concatenate(sink.embs)
    check(total == N and np.array_equal(np.sort(ids_), np.arange(N))
          and np.isfinite(embs).all(), f"{path}: the export is wrong")
    with torch.inference_mode(), plain_kernels():
        ref0 = tr.encode_batch(np.arange(BATCH, dtype=np.int32))
    err0 = rel_err(torch.as_tensor(embs[:BATCH]), ref0.float().cpu(),
                   f"{path}: batch 0 vs plain")
    emit({"phase": "weighted_inference_throughput", "path": path,
          "refresh_ms": refresh_ms, "nodes_per_s": N / inf_s,
          "ms_per_batch": inf_s / n_batches * 1e3,
          "batch0_max_abs_err": err0, "card": card})
    del tr, sink

    # -- the typed sampled path: DBLP's shape, every op weighted ------------
    path = "weighted_typed_encode"
    tg = typed_ctx["graph"]
    trng = np.random.default_rng(W_SEED + 2)
    edge_tables = {str(et): trng.random((coo.shape[1], W_DE),
                                        dtype=np.float32)
                   for et, coo in tg.edges.items()}
    wg = HeteroGraph(metadata=tg.metadata, num_nodes=tg.num_nodes,
                     edges=tg.edges, node_features=tg.node_features,
                     edge_features=edge_tables)
    paths_w = {nt: tuple(dataclasses.replace(op, method="weighted")
                         for op in ops)
               for nt, ops in typed_ctx["paths"].items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hdg = HeteroDeviceGraph.from_hetero(wg, paths_w, device=dev)
    torch.cuda.synchronize()
    typed_build_s = time.perf_counter() - t0
    ttr = HeteroNALPTrainer(
        HeteroLinkPredictionGNN(typed_ctx["make_encoder"]("hgt"),
                                LinkPredictionDecoder()), hdg, paths_w,
        HeteroNALPTrainerConfig("paper", "author"), device=dev)
    ttr.init_params(0)
    for nt in ("paper", "author"):   # warm-up batches, not timed
        ttr.encode_batch(np.arange(BATCH, dtype=np.int32), nt)
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embs = {}
    for nt in ("paper", "author"):
        embs[nt] = [ttr.encode_batch(np.arange(b_ * BATCH, (b_ + 1) * BATCH,
                                               dtype=np.int32), nt)
                    for b_ in range(W_TYPED_BATCHES)]
    torch.cuda.synchronize()
    typed_s = time.perf_counter() - t0
    c_ = dict(_build.launches)
    counts[path] = (c_, 2 * W_TYPED_BATCHES)
    emit({"phase": "main_path", "path": path, "launches": c_,
          "batches": 2 * W_TYPED_BATCHES})
    ops_per_batch = {"paper": len(paths_w["paper"]),
                     "author": len(paths_w["author"])}
    check(c_["sample_weighted"] == W_TYPED_BATCHES * sum(
        ops_per_batch.values()) and c_["sample_uniform"] == 0,
          f"{path}: {c_['sample_weighted']} K19 and {c_['sample_uniform']} "
          "K1 launches, not one K19 an op")
    errs = {}
    with torch.inference_mode():
        for nt in ("paper", "author"):
            ids0 = torch.arange(BATCH, dtype=torch.int32, device=dev)
            with plain_kernels():
                want = ttr._encode_impl(ttr.graph, ids0, nt, 0, False)
            errs[nt] = rel_err(embs[nt][0].float().cpu(), want.float().cpu(),
                               f"{path} {nt} batch 0 vs plain", tol=1e-5)
    emit({"phase": "weighted_typed_throughput", "path": path,
          "from_hetero_s": typed_build_s,
          "ms_per_batch": typed_s / (2 * W_TYPED_BATCHES) * 1e3,
          "max_abs_err_batch0": errs, "card": card})
    del ttr, hdg, wg, edge_tables, embs

    # -- the partitioned trainer over make_mesh(4), weighted -----------------
    path = "weighted_partitioned_train"
    mesh = make_mesh(PART_SHARDS, dev)
    pg = PartitionedGraph.build(dg, mesh)
    check(pg.msg_weights is not None, "the partitioned graph has no weights")
    base = dict(fanouts=FANOUTS, num_random_negs=R, loss_type="retrieval",
                num_positives=1, sampling_method="weighted")

    def part_trainer(model):
        return PartitionedNALPTrainer(
            model, pg, mesh, NALPTrainerConfig(**base),
            optimizer_args=opt_args, capacity_factor=PART_CAPACITY,
            overflow_policy="raise")

    chk = part_trainer(LinkPredictionGNN(
        GNNEncoder(D, HID, OUT, num_layers=2, conv="graphsage"),
        LinkPredictionDecoder()))
    chk.init_state(0)
    vs = step_vs_plain(chk.model.encoder,
                       lambda: chk.loss_and_sketch(a0, 0)[0],
                       _build.launches)
    emit({"phase": "weighted_step_vs_plain", "path": path, **vs})
    check(vs["loss_rel_err"] <= 1e-5,
          f"{path}: loss differs from the plain step: {vs}")
    check(vs["max_grad_err_rel_to_scale"] <= 1e-4,
          f"{path}: a gradient differs from the plain step: {vs}")
    del chk
    _build.reset_launches()
    mesh.reset_counts()
    ptr = part_trainer(make_model())
    state = ptr.init_state(0)
    gens = [torch.Generator(device=dev).manual_seed(s_)
            for s_ in range(PART_SHARDS)]
    state, warm = ptr.train_steps(state, anchors[:W_PART_WARMUP], gens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, losses = ptr.train_steps(
        state, anchors[W_PART_WARMUP: W_PART_WARMUP + W_PART_STEPS], gens)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) / W_PART_STEPS * 1e3
    nsteps = W_PART_WARMUP + W_PART_STEPS
    c_ = dict(_build.launches)
    counts[path] = (c_, nsteps)
    emit({"phase": "main_path", "path": path, "launches": c_,
          "steps": nsteps})
    # each step: 3 encode groups x 2 hops, one owner-side K19 per shard;
    # the positives' routed draw one K1 per shard
    check(c_["sample_weighted"] == 6 * PART_SHARDS * nsteps,
          f"{path}: {c_['sample_weighted']} K19 launches, not "
          f"{6 * PART_SHARDS} a step")
    check(c_["sample_uniform"] == PART_SHARDS * nsteps,
          f"{path}: {c_['sample_uniform']} K1 launches, not the positives' "
          f"{PART_SHARDS} a step")
    check(ptr.overflow_total == 0,
          f"{path}: {ptr.overflow_total} routed requests dropped")
    losses = losses.float().cpu().numpy()
    check(np.isfinite(losses).all() and np.isfinite(
        warm.float().cpu().numpy()).all(), f"{path}: loss not finite")
    emit({"phase": "weighted_partitioned_throughput", "path": path,
          "shards": PART_SHARDS, "steps": W_PART_STEPS,
          "ms_per_step": ms_step, "edges_per_step": edges_per_step,
          "edges_per_s": edges_per_step / (ms_step / 1e3),
          "a2a_bytes_per_step": mesh.a2a_bytes / nsteps,
          "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
          "overflow_total": ptr.overflow_total, "card": card})
    del ptr, state, pg, mesh, dg
    return counts


def coo_edge_phases(dev, card, graph, ea_np, fell, record, add_mode,
                    rel_err, unique, run_path):
    """Phase 17 (see the module docstring): the COO per-edge terms. The
    flagship graph's COO data (full_batch_data_from_graph(build_ell=False))
    and its walk-ordered relabelling (coo_walk, host build timed); each new
    kernel mode against its plain twin at the paths' shapes, timed beside
    its bound and a library call where one computes the same function; the
    edge-row order measured (walk order, random order, K3-gathered
    blocks); then per model a FullBatchTrainer(build_ell=False) step
    against its plain recomputation, the path itself and encode_coo against
    encode_ell. Returns {path: (launch counts, steps)} and {kernel: {mode:
    entry}}."""
    from gigl_tpu_torch.models.encoders import GNNEncoder
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.ops import ell as ell_ops
    from gigl_tpu_torch.ops import segment as seg
    from gigl_tpu_torch.ops.gather import gather_rows
    from gigl_tpu_torch.training.full_batch import (
        FullBatchTrainer, full_batch_data_from_graph)

    t0 = time.perf_counter()
    fb = full_batch_data_from_graph(graph, build_ell=False, device=dev)
    torch.cuda.synchronize()
    fb_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    walk = seg.coo_walk(fb.index, fb.src)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    ea = torch.as_tensor(ea_np, device=dev)
    src, dst, idx, sidx = fb.src, fb.dst, fb.index, fb.src_index
    ws, wd, widx, wsidx = walk.src, walk.dst, walk.index, walk.src_index
    ws_l, wd_l, src_l, dst_l = (t.long() for t in (ws, wd, src, dst))
    perm_l = walk.perm.long()
    check(torch.equal(ws_l, src_l[perm_l]) and torch.equal(wd_l, dst_l[perm_l])
          and torch.equal(widx.ptr, idx.ptr), "the walk-ordered graph is "
          "not the graph's edges by destination")
    emit({"phase": "coo_edge_graph", "full_batch_data_s": fb_s,
          "walk_build_s": walk_s, "edges": E,
          "edge_features": [E, EDGE_DE]})
    gen = torch.Generator(device=dev).manual_seed(17)
    h_, dh_ = GAT_HEADS, HID // GAT_HEADS
    u_src, u_dst = unique(src), unique(dst)
    ids_bytes = E * 8 + (N + 1) * 4      # order and gathered, the pointers
    modes = {}

    def time_mode(kname, mode, err, kernel, plain, nbytes, nops,
                  library=None, library_call=None, **extra):
        b_, by_ = bound_ms(nbytes, nops)
        entry = {"err": err, "ms": cuda_ms(kernel),
                 "plain_ms": cuda_ms(plain, reps=1),
                 "eager_ms": eager_ms(kernel, reps=10), "bound_ms": b_,
                 "bound_by": by_, "nbytes": nbytes,
                 "library_ms": None if library is None else cuda_ms(library),
                 "library_call": library_call, **extra}
        modes.setdefault(kname, {})[mode] = entry
        emit({"phase": "coo_edge_kernel", "name": kname, "mode": mode,
              **entry})
        return entry

    def repeat_equal(fn, what):
        a, b = fn(), fn()
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            check(torch.equal(u, v), f"{what}: a repeat run differs")
        return a

    # -- K8 gine at GINE's [2M, 128] fp32 (the walk-ordered graph: edge rows
    # read in sequence). bytes: each distinct source row, the edge rows, the
    # ids and pointers, [N, 128] out; ops: an add, a relu and a sum a value.
    # Yardstick: index_add_ of the gated rows (made beforehand).
    cg = EDGE_GINE_HID
    x8 = torch.randn((N, cg), generator=gen, device=dev)
    e8 = torch.randn((E, cg), generator=gen, device=dev)

    def k8g():
        return seg._segment_reduce_fwd(x8, wd, N, "sum", ws, None, widx, e8,
                                       "gine")

    def k8g_plain():
        return seg._segment_reduce_plain(x8, wd, N, "sum", ws, None, e8,
                                         "gine")

    got = repeat_equal(k8g, "K8 gine")
    err = rel_err(got, k8g_plain(), "K8 gine", tol=1e-5)
    gated = torch.relu(x8[ws_l] + e8)

    def k8g_lib():
        return torch.zeros((N, cg), device=dev).index_add_(0, wd_l, gated)

    rel_err(k8g_lib(), got, "index_add_ yardstick vs K8 gine", tol=1e-5)
    time_mode("segment_reduce", "coo_edge_gine", err, k8g, k8g_plain,
              u_src * cg * 4 + E * cg * 4 + ids_bytes + N * cg * 4,
              E * cg * 3, k8g_lib, "torch.Tensor.index_add_ of the gated "
              "rows relu(x[src] + e) by dst (made beforehand, not timed)",
              width=cg, edges=E)
    del gated

    # -- K8 add at EdgeAttrGAT layer 1's [2M, 4 x 64] fp32, weighted per head
    # (alpha), and the edge rows' order: walk order (kept: read in sequence),
    # the graph's own order (ea[order[j]], a random read of each row) and
    # K3-gathered blocks (the table gathered into walk order first, each
    # layer). All three give the same bits. bytes: as gine with the weights.
    xa = torch.randn((N, h_, dh_), generator=gen, device=dev)
    eaw = torch.randn((E, h_, dh_), generator=gen, device=dev)
    wa = torch.rand((E, h_), generator=gen, device=dev)
    eac, wac = torch.empty_like(eaw), torch.empty_like(wa)
    eac[perm_l], wac[perm_l] = eaw, wa          # the same edges, COO order

    def k8a(table=eaw):
        return seg._segment_reduce_fwd(xa, wd, N, "sum", ws, wa, widx, table,
                                       "add")

    def k8a_random():
        return seg._segment_reduce_fwd(xa, dst, N, "sum", src, wac, idx, eac,
                                       "add")

    def k8a_blocks():
        return k8a(gather_rows(eac.reshape(E, HID), walk.perm)[0].reshape(
            E, h_, dh_))

    def k3_blocks():
        return gather_rows(eac.reshape(E, HID), walk.perm)[0]

    def k8a_plain():
        return seg._segment_reduce_plain(xa, wd, N, "sum", ws, wa, eaw, "add")

    got = repeat_equal(k8a, "K8 add")
    check(torch.equal(got, k8a_random()) and torch.equal(got, k8a_blocks()),
          "K8 add: the three edge-row orders differ")
    err = rel_err(got, k8a_plain(), "K8 add", tol=1e-5)
    weighted = (xa[ws_l] + eaw) * wa[..., None]

    def k8a_lib():
        return torch.zeros((N, h_, dh_), device=dev).index_add_(0, wd_l,
                                                               weighted)

    rel_err(k8a_lib(), got, "index_add_ yardstick vs K8 add", tol=1e-5)
    order = {"walk_ms": cuda_ms(k8a), "random_ms": cuda_ms(k8a_random),
             "k3_blocks_ms": cuda_ms(k8a_blocks),
             "k3_gather_alone_ms": cuda_ms(k3_blocks)}
    order["kept"] = "walk"
    order["fastest"] = min(("walk", "random", "k3_blocks"),
                           key=lambda k_: order[f"{k_}_ms"])
    emit({"phase": "coo_edge_order", "table": [E, HID], "dtype": "float32",
          "card": card, **order})
    time_mode("segment_reduce", "coo_edge_add", err, k8a, k8a_plain,
              u_src * HID * 4 + E * HID * 4 + E * h_ * 4 + ids_bytes
              + N * HID * 4, E * HID * 3, k8a_lib,
              "torch.Tensor.index_add_ of the weighted rows alpha * (x[src] "
              "+ e) by dst (made beforehand, not timed)", width=HID,
              heads=h_, edges=E, order=order)
    del weighted, eac, wac

    # -- K8b gine over the source walk at [N, 128] fp32. bytes: each distinct
    # destination's cotangent row, x once, the edge rows, the ids and
    # pointers, [N, 128] out. Yardstick: index_add_ of the gated cotangent
    # rows by src (made beforehand).
    g8 = torch.randn((N, cg), generator=gen, device=dev)

    def k8bg():
        return seg.gine_bwd(g8, ws, wd, x8, e8, src_index=wsidx)

    def k8bg_plain():
        return seg._edge_bwd_plain(g8, wd, N, "gine", ws, None, x8, e8, None,
                                   0.2)

    got = repeat_equal(k8bg, "K8b gine")
    err = rel_err(got, k8bg_plain(), "K8b gine", tol=1e-5)
    gated = torch.where(x8[ws_l] + e8 > 0, g8[wd_l], 0.0)

    def k8bg_lib():
        return torch.zeros((N, cg), device=dev).index_add_(0, ws_l, gated)

    rel_err(k8bg_lib(), got, "index_add_ yardstick vs K8b gine", tol=1e-5)
    time_mode("segment_reduce_bwd", "coo_edge_gine", err, k8bg, k8bg_plain,
              u_dst * cg * 4 + N * cg * 4 + E * cg * 4 + ids_bytes
              + N * cg * 4, E * cg * 2, k8bg_lib,
              "torch.Tensor.index_add_ of the gated cotangent rows "
              "1[x[src] + e > 0] * g[dst] by src (made beforehand, not "
              "timed)", width=cg, edges=E)
    del gated, x8, e8, g8

    # -- K10 with the key addend at [2M, 4 x 64] fp32 (the walk-ordered
    # graph), scaled. bytes: each destination's q row once, each distinct
    # source's k row, the edge rows, the ids, [E, 4] out; ops: an add and a
    # multiply-add a value. No single library call adds the edge term.
    q10 = torch.randn((N, h_, dh_), generator=gen, device=dev)
    k10 = torch.randn((N, h_, dh_), generator=gen, device=dev)
    sc10 = torch.full((h_,), dh_ ** -0.5, device=dev)

    def k10a():
        return seg._sddmm_fwd(ws, wd, q10, k10, sc10, widx, edge=eaw)

    def k10a_plain():
        return seg._sddmm_plain(ws, wd, q10, k10, sc10, edge=eaw)

    got = repeat_equal(k10a, "K10 addend")
    err = rel_err(got, k10a_plain(), "K10 addend", tol=1e-5)
    time_mode("sddmm", "coo_edge_addend", err, k10a, k10a_plain,
              N * HID * 4 + u_src * HID * 4 + E * HID * 4 + ids_bytes
              + E * h_ * 4, E * HID * 3, heads=h_, head_dim=dh_, edges=E)

    # -- GATv2 at [2M, 4 x 64] fp32 over the graph's own order (the GATv2
    # path reads no edge rows): K10's scores, K8b's source walk (d hs) and
    # K8's destination walk (d hd and d att, the partials summed in a fixed
    # order). bytes: the two tables' rows once each (hs: distinct sources),
    # att, the ids, out ([E, 4]; d hs, d hd [N, 256]; gl [E, 4] read);
    # ops: an add, the leaky and a multiply-add a value (backward: + the
    # derivative's select and a multiply).
    hs10, hd10 = k10, q10
    att10 = torch.randn((h_, dh_), generator=gen, device=dev)
    gl10 = torch.randn((E, h_), generator=gen, device=dev)

    def k10v():
        return seg._sddmm_fwd(src, dst, hd10, hs10, index=idx, att=att10)

    def k10v_plain():
        return seg._sddmm_plain(src, dst, hd10, hs10, att=att10)

    got = repeat_equal(k10v, "K10 gatv2")
    err = rel_err(got, k10v_plain(), "K10 gatv2", tol=1e-5)
    time_mode("sddmm", "coo_gatv2", err, k10v, k10v_plain,
              N * HID * 4 + u_src * HID * 4 + HID * 4 + ids_bytes
              + E * h_ * 4, E * HID * 4, heads=h_, head_dim=dh_, edges=E)

    def k8bv():
        return seg.gatv2_src_bwd(gl10, src, dst, hs10, hd10, att10,
                                 src_index=sidx)

    def k8bv_plain():
        return seg._edge_bwd_plain(hd10.reshape(N, HID), dst, N, "gatv2",
                                   src, gl10, hs10.reshape(N, HID), None,
                                   att10, 0.2)

    got = repeat_equal(k8bv, "K8b gatv2")
    err = rel_err(got, k8bv_plain(), "K8b gatv2", tol=1e-5)
    time_mode("segment_reduce_bwd", "coo_gatv2", err, k8bv, k8bv_plain,
              N * HID * 4 + u_dst * HID * 4 + HID * 4 + E * h_ * 4
              + ids_bytes + N * HID * 4, E * HID * 4, heads=h_,
              head_dim=dh_, edges=E)

    def k8v():
        return seg.gatv2_dst_bwd(gl10, src, dst, hs10, hd10, att10,
                                 index=idx)

    def k8v_plain():
        return seg._gatv2_dst_plain(gl10, src, dst, hs10, hd10, att10, 0.2)

    got = repeat_equal(k8v, "K8 gatv2")
    want = k8v_plain()
    err = rel_err(got[0], want[0], "K8 gatv2 d hd", tol=1e-5)
    # d att against an fp64 sum, over sum |terms| (as K10b's dscale)
    z = (hs10.reshape(N, HID).double()[src_l]
         + hd10.reshape(N, HID).double()[dst_l])
    terms = torch.where(z >= 0, z, 0.2 * z) * gl10.double(
        ).repeat_interleave(dh_, 1)
    del z
    datt_rel = float(((got[1].double() - terms.sum(0)).abs()
                      / terms.abs().sum(0)).max())
    del terms
    check(datt_rel <= 1e-6, f"K8 gatv2 d att {datt_rel} of sum |terms| "
          "from an fp64 sum (limit 1e-6)")
    time_mode("segment_reduce", "coo_gatv2_dst", err, k8v,
              lambda: k8v_plain()[0],
              u_src * HID * 4 + N * HID * 4 + HID * 4 + E * h_ * 4
              + ids_bytes + N * HID * 4, E * HID * 6, heads=h_,
              head_dim=dh_, edges=E, datt_err_rel_to_abs_sum=datt_rel)
    del q10, k10, hs10, hd10, gl10, got, want

    # -- K11's COO form at [2M, 256] fp32 (the walk-ordered graph), three
    # modes. bytes: the pointers and order, each destination's g row (and
    # xd row) once, alpha and coef [E, 4], [E, 256] written (gine: + the
    # gathered ids, each distinct source's x row and the edge rows); ops: 3
    # a value. Yardstick: index_select of g by dst, the [E, 256] block of
    # each edge's destination cotangent (the per-edge terms not applied).
    g11, xd11, x11 = (torch.randn((N, HID), generator=gen, device=dev)
                      for _ in range(3))
    e11 = eaw.reshape(E, HID)
    al11 = torch.rand((E, h_), generator=gen, device=dev)
    cf11 = torch.randn((E, h_), generator=gen, device=dev)
    vec11 = torch.randn(HID, generator=gen, device=dev)

    def k11_lib():
        return torch.index_select(g11, 0, wd_l)

    for mode in ("gat", "transformer", "gine"):
        kw = {"gat": dict(alpha=al11, coef=cf11, vec=vec11, heads=h_),
              "transformer": dict(alpha=al11, coef=cf11, xd=xd11, heads=h_),
              "gine": dict(x=x11, ea=e11)}[mode]

        def k11(mode=mode, kw=kw):
            return ell_ops.coo_edge_grad(g11, ws, wd, widx, mode, **kw)

        def k11_plain(mode=mode, kw=kw):
            return ell_ops._coo_edge_grad_plain(g11, ws, wd, mode, **kw)

        got = repeat_equal(k11, f"K11 COO {mode}")
        want = k11_plain()
        if mode == "gine":
            check(torch.equal(got, want), "K11 COO gine is not bit-equal")
            err = 0.0
        else:
            err = rel_err(got, want, f"K11 COO {mode}", tol=1e-6)
        del got, want
        nbytes = (E * 4 + (N + 1) * 4 + u_dst * HID * 4 + E * HID * 4
                  + {"gat": E * h_ * 8 + HID * 4,
                     "transformer": E * h_ * 8 + u_dst * HID * 4,
                     "gine": E * 4 + u_src * HID * 4 + E * HID * 4}[mode])
        time_mode("ell_edge_grad", f"coo_{mode}", err, k11, k11_plain,
                  nbytes, E * HID * 3, k11_lib,
                  "torch.index_select of the [N, 256] cotangent by dst "
                  "(each edge's destination row; the per-edge terms not "
                  "applied)", edges=E, width=HID)

    # -- GATv2 with edge rows (ROADMAP B6b) at [2M, 4 x 64] fp32 over the
    # walk-ordered graph (edge rows read in sequence): K10's gatv2 mode with
    # the edge row (beside its mode without, same call), K8's destination
    # walk with it (d hd; d att within 1e-6 of sum |terms| of an fp64 sum),
    # K11's gatv2 mode (the edge table's cotangent) and K8b's sum of that
    # [E, 256] table along the source walk (the source table's cotangent;
    # yardstick index_add_ by src). Beside K8b, the design it replaced:
    # the value walk (K8b weighted by alpha) and the gate walk (K8b's GATv2
    # mode, without even the edge row) over the same source index.
    hs_v, hd_v = (torch.randn((N, h_, dh_), generator=gen, device=dev)
                  for _ in range(2))
    att_v = torch.randn((h_, dh_), generator=gen, device=dev)
    gl_v = torch.randn((E, h_), generator=gen, device=dev)

    def k10ve(edges=True):
        return seg._sddmm_fwd(ws, wd, hd_v, hs_v, index=widx,
                              edge=eaw if edges else None, att=att_v)

    def k10ve_plain():
        return seg._sddmm_plain(ws, wd, hd_v, hs_v, edge=eaw, att=att_v)

    got = repeat_equal(k10ve, "K10 gatv2 edge")
    err = rel_err(got, k10ve_plain(), "K10 gatv2 edge", tol=1e-5)
    time_mode("sddmm", "coo_gatv2_edge", err, k10ve, k10ve_plain,
              N * HID * 4 + u_src * HID * 4 + E * HID * 4 + HID * 4
              + ids_bytes + E * h_ * 4, E * HID * 5, heads=h_,
              head_dim=dh_, edges=E,
              ms_without_edge_rows_same_call=cuda_ms(lambda: k10ve(False)))

    def k8ve():
        return seg.gatv2_dst_bwd(gl_v, ws, wd, hs_v, hd_v, att_v, index=widx,
                                 edge=eaw)

    def k8ve_plain():
        return seg._gatv2_dst_plain(gl_v, ws, wd, hs_v, hd_v, att_v, 0.2,
                                    eaw)

    got = repeat_equal(k8ve, "K8 gatv2 edge")
    err = rel_err(got[0], k8ve_plain()[0], "K8 gatv2 edge d hd", tol=1e-5)
    z = ((hs_v.reshape(N, HID).double()[ws_l] + eaw.reshape(E, HID).double())
         + hd_v.reshape(N, HID).double()[wd_l])
    terms = torch.where(z >= 0, z, 0.2 * z) * gl_v.double(
        ).repeat_interleave(dh_, 1)
    del z
    datt_rel = float(((got[1].double() - terms.sum(0)).abs()
                      / terms.abs().sum(0)).max())
    del terms
    check(datt_rel <= 1e-6, f"K8 gatv2 edge d att {datt_rel} of sum |terms| "
          "from an fp64 sum (limit 1e-6)")
    time_mode("segment_reduce", "coo_gatv2_dst_edge", err, k8ve,
              lambda: k8ve_plain()[0],
              u_src * HID * 4 + E * HID * 4 + N * HID * 4 + HID * 4
              + E * h_ * 4 + ids_bytes + N * HID * 4, E * HID * 7,
              heads=h_, head_dim=dh_, edges=E,
              datt_err_rel_to_abs_sum=datt_rel)
    kw_v = dict(x=x11, ea=e11, alpha=al11, coef=cf11, vec=vec11, xd=xd11,
                heads=h_)

    def k11v():
        return ell_ops.coo_edge_grad(g11, ws, wd, widx, "gatv2", **kw_v)

    def k11v_plain():
        return ell_ops._coo_edge_grad_plain(g11, ws, wd, "gatv2", **kw_v)

    got = repeat_equal(k11v, "K11 COO gatv2")
    err = rel_err(got, k11v_plain(), "K11 COO gatv2", tol=1e-6)
    time_mode("ell_edge_grad", "coo_gatv2", err, k11v, k11v_plain,
              E * 8 + (N + 1) * 4 + 2 * u_dst * HID * 4 + u_src * HID * 4
              + 2 * E * HID * 4 + E * h_ * 8 + HID * 4, E * HID * 6,
              k11_lib, "torch.index_select of the [N, 256] cotangent by dst "
              "(each edge's destination row; the per-edge terms not "
              "applied)", edges=E, width=HID)

    def k8be():
        return seg.edge_rows_by_source(got, ws, N, src_index=wsidx)

    def k8be_plain():
        return seg._edge_rows_by_source_plain(got, ws, N)

    summed = repeat_equal(k8be, "K8b edge rows")
    err = rel_err(summed, k8be_plain(), "K8b edge rows", tol=1e-5)

    def k8be_lib():
        return torch.zeros((N, HID), device=dev).index_add_(0, ws_l, got)

    rel_err(k8be_lib(), summed, "index_add_ vs K8b edge rows", tol=1e-5)
    gate_walk_ms = cuda_ms(lambda: seg.gatv2_src_bwd(
        gl_v, ws, wd, hs_v, hd_v, att_v, src_index=wsidx))
    value_walk_ms = cuda_ms(lambda: seg.segment_reduce_bwd(
        g11, wd, N, src=ws, weight=al11, index=widx, src_index=wsidx))
    time_mode("segment_reduce_bwd", "coo_edge_rows", err, k8be, k8be_plain,
              E * HID * 4 + E * 4 + (N + 1) * 4 + N * HID * 4, E * HID,
              k8be_lib, "torch.Tensor.index_add_ of the [E, 256] rows by src",
              edges=E, width=HID,
              gate_read_alternative_ms={"value_walk": value_walk_ms,
                                        "gate_walk": gate_walk_ms,
                                        "sum": value_walk_ms + gate_walk_ms})
    del hs_v, hd_v, att_v, gl_v, got, summed, kw_v
    del g11, xd11, x11, e11, al11, cf11, eaw, xa, wa
    torch.cuda.empty_cache()

    # -- per model: a step against the plain twins, the path, and
    # encode_coo against encode_ell on the card ----------------------------
    counts = {}
    for model_name, (conv, hid, kw, edged, kernels) in COO_EDGE_MODELS.items():
        path = f"coo_edge_full_batch_{model_name}"
        ea_leaf = torch.nn.Parameter(ea.clone()) if edged else None
        fbt = FullBatchTrainer(
            GNNEncoder(D, hid, C, num_layers=2, conv=conv, conv_kwargs=kw,
                       edge_dim=EDGE_DE if edged else None),
            dataclasses.replace(fb, edge_attr=ea_leaf),
            optimizer_args={"learning_rate": "1e-2"}, device=dev)
        state = fbt.init_state(0)
        gates = (coo_edge_gate_flips(walk, "gine" if conv == "gine"
                                     else "gat")
                 if conv in ("gine", "edge_attr_gat")
                 else gatv2_gate_replay() if conv == "gatv2"
                 else contextlib.nullcontext())   # GATv2 with edge rows too
        with gates as explain:
            # the Transformer's key bias shifts all of a destination's
            # logits alike, so the softmax leaves it no gradient
            vs = step_vs_plain(
                fbt.encoder, fbt.loss, _build.launches,
                symmetric=tuple(f"convs.{i}.lin_k.bias" for i in range(2)
                                if conv == "transformer"),
                extra=None if ea_leaf is None else {"edge_attr": ea_leaf},
                explain=None if conv == "gatv2" else explain)
            if conv == "gatv2":
                vs.update(explain())
        emit({"phase": "coo_edge_full_batch_step_vs_plain",
              "model": model_name, **vs})
        check(vs["loss_rel_err"] <= 1e-5,
              f"{path}: loss differs from the plain step: {vs}")
        check(vs["max_grad_err_rel_to_scale"] <= 1e-4,
              f"{path}: a gradient differs from the plain step: {vs}")
        # the trainer's own data: edge features are inputs, not weights
        fbt.data = dataclasses.replace(fb, edge_attr=ea if edged else None)
        cnt_, nsteps, row = run_path(path, fbt, state, CE_STEPS, CE_WARMUP,
                                     CE_PROFILED, kernels)
        counts[path] = (cnt_, nsteps)
        with torch.no_grad():
            via_coo = fbt.encoder.encode_coo(
                fb.x, fb.src, fb.dst, N, ea if edged else None,
                index=fb.index, src_index=fb.src_index)
            via_ell = fbt.encoder.encode_ell(fb.x, fell,
                                             ea if edged else None)
        coo_vs_ell = rel_err(via_coo, via_ell, f"{path}: encode_coo against "
                             "encode_ell", tol=1e-4)
        step_s = row["ms_per_step"] / 1e3
        emit({"phase": "coo_edge_full_batch_train_throughput",
              "model": model_name, "edges_per_step": 2 * E,
              "edges_per_s": 2 * E / step_s, "nodes_per_s": N / step_s,
              "encode_coo_vs_ell_max_abs_err": coo_vs_ell,
              "encode_coo_vs_ell_scale": float(via_ell.abs().max()), **row})
        del fbt, state, ea_leaf, via_coo, via_ell
    torch.cuda.empty_cache()
    # each mode's launches on the paths (its counter, per step)
    counter = {("segment_reduce", "coo_edge_gine"): "segment_reduce_gine",
               ("segment_reduce", "coo_edge_add"): "segment_reduce_add",
               ("segment_reduce", "coo_gatv2_dst"): "segment_reduce_gatv2",
               ("segment_reduce_bwd", "coo_edge_gine"):
                   "segment_reduce_bwd_gine",
               ("segment_reduce_bwd", "coo_gatv2"):
                   "segment_reduce_bwd_gatv2",
               ("sddmm", "coo_edge_addend"): "sddmm_addend",
               ("sddmm", "coo_gatv2"): "sddmm_gatv2",
               ("ell_edge_grad", "coo_gine"): "ell_edge_grad_coo",
               ("ell_edge_grad", "coo_gat"): "ell_edge_grad_coo",
               ("ell_edge_grad", "coo_transformer"): "ell_edge_grad_coo",
               ("sddmm", "coo_gatv2_edge"): "sddmm_gatv2_edge",
               ("segment_reduce", "coo_gatv2_dst_edge"):
                   "segment_reduce_gatv2_edge",
               ("ell_edge_grad", "coo_gatv2"): "ell_edge_grad_gatv2",
               ("segment_reduce_bwd", "coo_edge_rows"):
                   "segment_reduce_bwd_edge_rows"}
    owner = {"coo_gine": "gine", "coo_gat": "edge_attr_gat",
             "coo_transformer": "transformer", "coo_gatv2": "gatv2_edges"}
    for kname, by_mode in modes.items():
        for mode, entry in by_mode.items():
            key = counter[(kname, mode)]
            per = {p_: c_[key] / n_ for p_, (c_, n_) in counts.items()
                   if kname != "ell_edge_grad"
                   or p_.endswith(owner[mode])}
            entry["launches"] = int(sum(per[p_] * counts[p_][1]
                                        for p_ in per))
            entry["launches_per_step"] = per
            check(entry["launches"] > 0, f"{kname} {mode} was not launched "
                  "on its path")
            del entry["nbytes"]
    return counts, modes


def partitioned_tabularized_phases(dev, card, dg, record, add_mode, unique,
                                   make_model, opt_args):
    """Phase 18 (see the module docstring): the partitioned tier's int8
    rows, tabularized layout and node-classification trainer over
    PART_SHARDS shards on the card. Returns {path: (launch counts, steps
    or passes)}; K16's int8 mode, K12's packed-row mode and K3's byte mode
    land on their kernels' rows as modes."""
    from gigl_tpu_torch.inference.inferencer import (
        InferenceConfig, run_partitioned_inference)
    from gigl_tpu_torch.models.encoders import GNNEncoder
    from gigl_tpu_torch.models.link_prediction import (
        LinkPredictionDecoder, LinkPredictionGNN)
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.ops import quantized as q8
    from gigl_tpu_torch.ops.gather import _gather_rows_plain, gather_rows
    from gigl_tpu_torch.parallel import feature_lookup as fl
    from gigl_tpu_torch.parallel.mesh import make_mesh
    from gigl_tpu_torch.training.dist_sampled import (
        PartitionedGraph, PartitionedNALPTrainer,
        PartitionedNodeClassificationTrainer)
    from gigl_tpu_torch.training.trainer import (
        NALPTrainerConfig, NodeClassificationTrainerConfig)

    k1, k2 = FANOUTS
    shards = PART_SHARDS
    counts = {}
    mesh = make_mesh(shards)
    graphs, build_s = {}, {}
    for kind, quantize in (("fp32", False), ("int8", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graphs[kind] = PartitionedGraph.build(dg, mesh,
                                              quantize_features=quantize)
        torch.cuda.synchronize()
        build_s[kind] = time.perf_counter() - t0
    tabs, tab_s = {}, {}
    for kind, pg in graphs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tabs[kind] = pg.with_tabularized(mesh, fanouts=FANOUTS, agg="mean",
                                         capacity_factor=PART_CAPACITY)
        torch.cuda.synchronize()
        tab_s[kind] = time.perf_counter() - t0
    emit({"phase": "partitioned_q8_graph", "shards": shards,
          "rows_per_shard": graphs["fp32"].rows_per_shard,
          "build_s": build_s, "with_tabularized_s": tab_s,
          "row_bytes": {k_: g_.feat_deg[0].shape[1]
                        * g_.feat_deg[0].element_size()
                        for k_, g_ in graphs.items()},
          "feat_deg_bytes_per_shard": {k_: g_.feat_deg[0].nbytes
                                       for k_, g_ in graphs.items()},
          "tabularized_bytes_per_shard": {
              k_: t_.feat_deg[0].nbytes + sum(x_[0].nbytes for x_ in
                                              t_.sample_tables)
              for k_, t_ in tabs.items()},
          "labels_bytes_per_shard": graphs["fp32"].labels[0].nbytes,
          "card": card})

    # -- the sharded tables on the card against the replicated builder's
    # (bit-equal), the fp32 cache against its K2 cache (K4's sums and K2's
    # in another order: 1e-5 of the scale), the int8 cache's dequantized
    # values within one step of their row's scale
    rep = dg.with_neighbor_cache(fanout=k2, seed=0, hop_key=len(FANOUTS),
                                 agg="mean", table_fanouts=(k1,))
    for kind, t_ in tabs.items():
        check(t_.table_fanouts == (k1,) and torch.equal(
            torch.cat(t_.sample_tables[0])[:N], rep.sample_tables[k1]),
              f"the {kind} sharded sample tables differ from the "
              "replicated builder's")
    c32 = torch.cat(tabs["fp32"].feat_deg)[:N, D + 1:]
    scale32 = float(rep.nbr_cache.abs().max())
    err32 = float((c32 - rep.nbr_cache).abs().max())
    check(err32 <= 1e-5 * scale32, f"the sharded fp32 cache differs from "
          f"the replicated K2 cache: {err32} (scale {scale32})")
    # the int8 graph's cache aggregates the dequantized features: held to
    # K2's int8 mode over the same int8 features (QuantizedTable's host
    # recipe is the partitioned build's)
    qtab = q8.QuantizedTable.quantize(dg.node_features, device=dev)
    rep8 = dataclasses.replace(dg, node_features=qtab).with_neighbor_cache(
        fanout=k2, seed=0, hop_key=len(FANOUTS), agg="mean")
    f8, _, c8 = q8.decode_packed_rows(torch.cat(tabs["int8"].feat_deg)[:N],
                                      D, D)
    check(torch.equal(f8, qtab.q.float() * qtab.scale),
          "the int8 rows' features are not the quantized table's")
    step8 = c8.abs().amax(1, keepdim=True) / 127.0
    err8 = float(((c8 - rep8.nbr_cache).abs() / step8.clamp(min=1e-30))
                 .max())
    check(err8 <= 0.5 + 1e-3, f"the int8 cache is {err8} quantization "
          "steps from K2's cache of the same int8 features")
    emit({"phase": "partitioned_tabularized_checks", "tables_bit_equal":
          True, "fp32_cache_max_abs_err": err32, "fp32_cache_scale": scale32,
          "int8_cache_max_err_in_quantization_steps": err8})
    del rep, rep8, qtab, c32, f8, c8, step8

    base = dict(fanouts=FANOUTS, num_random_negs=R, loss_type="retrieval",
                num_positives=1, cached_hop=True)

    def fp32_model():
        return LinkPredictionGNN(GNNEncoder(D, HID, OUT, num_layers=2,
                                            conv="graphsage"),
                                 LinkPredictionDecoder())

    def nalp(model, kind, **kw):
        return PartitionedNALPTrainer(
            model, graphs[kind], mesh, NALPTrainerConfig(**base, **kw),
            optimizer_args=opt_args, capacity_factor=PART_CAPACITY,
            overflow_policy="raise")

    def nc_model(dtype=torch.float32):
        return GNNEncoder(D, HID, C, num_layers=2, conv="graphsage",
                          dtype=dtype)

    def nc(model, kind, cached):
        return PartitionedNodeClassificationTrainer(
            model, graphs[kind], mesh, NodeClassificationTrainerConfig(
                fanouts=FANOUTS, cached_hop=cached),
            optimizer_args={"learning_rate": "1e-2"},
            capacity_factor=PART_CAPACITY, overflow_policy="raise")

    n_anchor = PART_WARMUP + PART_STEPS + PART_PROFILED
    anchors = (np.arange(BATCH * n_anchor) % N).astype(np.int32).reshape(
        n_anchor, BATCH)
    a0 = torch.as_tensor(anchors[0], device=dev)

    # -- each cached NALP step (fp32 weights, the sketch on) and each NC
    # step against the plain twins; the int8 step's routed calls recorded
    for kind in ("fp32", "int8"):
        t_ = nalp(fp32_model(), kind, use_cms_correction=True)
        st = t_.init_state(0)
        vs = step_vs_plain(t_.model.encoder, lambda: t_.loss_and_sketch(
            a0, 0, st.cms)[0], _build.launches)
        emit({"phase": "partitioned_cached_step_vs_plain", "rows": kind,
              **vs})
        check(vs["loss_rel_err"] <= 1e-5 and
              vs["max_grad_err_rel_to_scale"] <= 1e-4,
              f"partitioned cached {kind} step differs from the plain "
              f"step: {vs}")
    with spy(fl, "unroute_rows_q8", lambda a, k: tuple(
            x_.clone() if torch.is_tensor(x_) else x_ for x_ in a)) as q8s, \
            spy(fl, "unroute_rows", lambda a, k: a[0].dtype) as plain_types:
        t_.loss_and_sketch(a0, 0, st.cms)[0].backward()
    torch.cuda.synchronize()
    check(len(q8s) == shards and torch.int8 not in plain_types,
          f"the int8 step decoded {len(q8s)} unroutes with K16's int8 mode "
          f"and routed {plain_types.count(torch.int8)} int8 rows through "
          "K16's copy form, not one decoded union gather a shard")
    del t_, st
    for cached, kind in ((False, "fp32"), (True, "int8")):
        t_ = nc(nc_model(), kind, cached)
        t_.init_state(0)
        vs = step_vs_plain(t_.model, lambda: t_.loss_and_overflow(a0)[0],
                           _build.launches)
        emit({"phase": "partitioned_nc_step_vs_plain", "cached": cached,
              "rows": kind, **vs})
        check(vs["loss_rel_err"] <= 1e-5 and
              vs["max_grad_err_rel_to_scale"] <= 1e-4,
              f"partitioned NC ({kind}, cached {cached}) step differs from "
              f"the plain step: {vs}")
        del t_

    # -- K16's int8 mode at the cached int8 step's union lookup ([P, G]
    # requests of [D + Dc + 12]-byte rows), and at the live step's union
    # shape over the uncached [D + 8] rows (phase 14's [4, 63,744]):
    # bit-equal to the twin, beside K16's 4-byte form over the same bytes.
    # bytes: owner / pos / ok read, each answered row's W bytes read once,
    # 4 (D + Dc) + 4 bytes written a request.
    live_g = (2 * BATCH + R) // shards * (1 + k1 + k1 * k2)
    union_g = (2 * BATCH + R) // shards * (1 + k1)

    def k16_q8(back, owner, pos, ok, d_, dc_):
        got_ = fl.unroute_rows_q8(back, owner, pos, ok, d_, dc_)
        want_ = fl._unroute_q8_plain(back, owner, pos, ok, d_, dc_)
        check(all((g_ is None and w_ is None) or torch.equal(g_, w_)
                  for g_, w_ in zip(got_, want_)),
              "K16's int8 mode is not bit-equal to its twin")
        g_ = owner.numel()
        words = back.view(torch.int32)
        return {"err": 0.0, "answers": list(back.shape), "requests": g_,
                "row_bytes": back.shape[2], "feat_dim": d_,
                "cache_dim": dc_,
                "ms": cuda_ms(lambda: fl.unroute_rows_q8(
                    back, owner, pos, ok, d_, dc_)),
                "plain_ms": cuda_ms(lambda: fl._unroute_q8_plain(
                    back, owner, pos, ok, d_, dc_)),
                "word4_copy_ms": cuda_ms(lambda: fl.unroute_rows(
                    words, owner, pos, ok)),
                "bound_ms": bound_ms(g_ * 9 + int(ok.sum()) * back.shape[2]
                                     + g_ * (4 * (d_ + dc_) + 4), 0)[0],
                "bound_by": "bytes", "library_ms": None,
                "eager_ms": eager_ms(lambda: fl.unroute_rows_q8(
                    back, owner, pos, ok, d_, dc_))}

    k16_step = k16_q8(*q8s[0][:6])
    ids_live = torch.randint(0, N, (shards, live_g), dtype=torch.int32,
                             device=dev, generator=torch.Generator(
                                 device=dev).manual_seed(18))
    cap = fl.request_capacity(live_g, shards, PART_CAPACITY)
    req, owner_l, pos_l, ok_l = fl.route_requests(
        ids_live, graphs["int8"].rows_per_shard, shards, cap)
    back_l = mesh.all_to_all([fl.answer_gather(
        q_, graphs["int8"].feat_deg[q_], req[q_]) for q_ in range(shards)])
    k16_live = k16_q8(back_l[0], owner_l[0], pos_l[0], ok_l[0], D, 0)
    add_mode("unroute_rows", "int8_decode", {
        **k16_step, "of": "the cached int8 step's union lookup, shard 0",
        "live_union": k16_live})
    del back_l, req, q8s

    # -- K12's packed-row mode (one shard's closed form) over the P = 1
    # layout of the cached int8 rows ([N, D + Dc + 12]: the four shards'
    # blocks in order) at the cached step's union ids and at the live
    # union's, bit-equal to the twin, beside K3 over the same packed rows
    # (the gather without the decode). bytes: the ids, each distinct
    # gathered row's W bytes, the decoded rows written.
    packed = torch.cat(tabs["int8"].feat_deg)

    def k12_packed(ids_):
        got_ = q8.gather_packed_rows_q8(packed, ids_, D, D)
        want_ = q8._gather_packed_rows_q8_plain(packed, ids_, D, D)
        check(all(torch.equal(g_, w_) for g_, w_ in zip(got_, want_)),
              "K12's packed-row mode is not bit-equal to its twin")
        m_ = ids_.numel()
        return {"err": 0.0, "ids": m_, "row_bytes": packed.shape[1],
                "ms": cuda_ms(lambda: q8.gather_packed_rows_q8(
                    packed, ids_, D, D)),
                "plain_ms": cuda_ms(lambda: q8._gather_packed_rows_q8_plain(
                    packed, ids_, D, D)),
                "k3_rows_ms": cuda_ms(lambda: gather_rows(packed, ids_)),
                "bound_ms": bound_ms(m_ * 4 + unique(ids_) * packed.shape[1]
                                     + m_ * (8 * D + 4), 0)[0],
                "bound_by": "bytes", "library_ms": None}

    add_mode("gather_rows_q8", "packed_rows", {
        **k12_packed(ids_live[:, :union_g].reshape(-1)),
        "of": "the cached step's union size, every shard's, over the "
              "P = 1 layout [N, D + D + 12]",
        "live_union": k12_packed(ids_live.reshape(-1))})
    # K3's byte mode: rows whose width is not a multiple of 4 bytes (the
    # [N, D + 8] rows of a 13-wide graph's layout: 21 bytes)
    odd = packed[:, :21]
    ids_b = ids_live[0]
    got_b = gather_rows(odd, ids_b)[0]
    check(torch.equal(got_b, _gather_rows_plain(odd, ids_b)[0]),
          "K3's byte mode is not bit-equal")
    add_mode("gather_rows", "bytes_21", {
        "err": 0.0, "rows": ids_b.numel(), "row_bytes": 21,
        "ms": cuda_ms(lambda: gather_rows(odd, ids_b)),
        "plain_ms": cuda_ms(lambda: _gather_rows_plain(odd, ids_b)),
        "bound_ms": bound_ms(ids_b.numel() * (4 + 21)
                             + unique(ids_b) * 21, 0)[0],
        "bound_by": "bytes", "library_ms": cuda_ms(
            lambda: torch.index_select(odd, 0, ids_b.long()))})
    del packed, odd, ids_live, got_b

    def run(path, trainer, steps_args, kernels):
        """Warm-up and timed steps (the launch counts were reset before
        the trainer and its tables were built; read just after), then
        profiled steps: (ms/step, losses, launches a step past the build,
        all_to_all bytes, profile, state)."""
        state = trainer.init_state(0)
        gens = [torch.Generator(device=dev).manual_seed(s_)
                for s_ in range(shards)]
        built = dict(_build.launches)
        state, warm = trainer.train_steps(state, steps_args[:PART_WARMUP],
                                          gens)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, losses = trainer.train_steps(
            state, steps_args[PART_WARMUP: PART_WARMUP + PART_STEPS], gens)
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t1) / PART_STEPS * 1e3
        nsteps = PART_WARMUP + PART_STEPS
        counts[path] = (dict(_build.launches), nsteps)
        emit({"phase": "main_path", "path": path,
              "launches": counts[path][0], "steps": nsteps})
        for k in kernels:
            check(counts[path][0][k] > 0, f"{k} was not launched on {path}")
        check(trainer.overflow_total == 0,
              f"{path}: {trainer.overflow_total} routed requests dropped")
        losses = losses.float().cpu().numpy()
        check(np.isfinite(losses).all() and np.isfinite(
            warm.float().cpu().numpy()).all(), f"{path}: loss not finite")
        per_step = {k_: (v_ - built[k_]) / nsteps for k_, v_ in
                    counts[path][0].items() if v_ - built[k_]}
        a2a = mesh.a2a_bytes
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            state, _ = trainer.train_steps(
                state, steps_args[PART_WARMUP + PART_STEPS:], gens)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t1) * 1e6
        return ms_step, losses, per_step, a2a, profile_summary(
            prof, PART_PROFILED, window_us, ms_step), state

    # -- the cached NALP paths (bf16, the sketch on), fp32 and int8 rows
    cached_kernels = PART_TRAIN_KERNELS + ("retrieval_loss",)
    # counted as bench.py:631-638 counts the cached flagship step's
    edges_per_step = (2 * k1 + k1 * k2) * (BATCH + BATCH + R)
    for path, kind in (("partitioned_cached_train", "fp32"),
                       ("partitioned_cached_q8_train", "int8")):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        _build.reset_launches()
        t0 = time.perf_counter()
        trainer = nalp(make_model(), kind, use_cms_correction=True)
        torch.cuda.synchronize()
        construct_s = time.perf_counter() - t0
        mesh.reset_counts()
        ms_step, losses, per_step, a2a, prof, state = run(
            path, trainer, anchors,
            cached_kernels + (("unroute_rows_q8",) if kind == "int8"
                              else ()))
        nsteps = PART_WARMUP + PART_STEPS
        if kind == "int8":
            check(per_step.get("unroute_rows_q8") == shards
                  and per_step.get("gather_rows_q8_packed", 0) == 0,
                  f"{path}: {per_step} — not one K16 int8 decode a shard a "
                  "step")
        total = int(state.cms.total)
        check(total == (nsteps + PART_PROFILED) * (BATCH + R),
              f"{path}: the sketch counted {total}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.refresh_cache(1)
        torch.cuda.synchronize()
        refresh_ms = (time.perf_counter() - t0) * 1e3
        emit({"phase": "partitioned_cached_train_throughput", "rows": kind,
              "shards": shards, "steps": PART_STEPS, "ms_per_step": ms_step,
              "edges_per_step": edges_per_step,
              "edges_per_s": edges_per_step / (ms_step / 1e3),
              "seeds_per_s": BATCH / (ms_step / 1e3),
              "launches_per_step": per_step,
              "a2a_bytes_per_step": a2a / nsteps,
              "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
              "sketch_total": total, "overflow_total": trainer.overflow_total,
              "trainer_build_s": construct_s, "refresh_ms": refresh_ms,
              "peak_mem_gb": (torch.cuda.max_memory_allocated() - base_mem)
              / 2**30, "profile": prof, "card": card})
        del trainer, state

    # -- the NC paths (bf16, 16 classes): live over fp32 rows, cached over
    # int8 rows; then run_partitioned_inference through the cached one
    nodes = anchors
    for path, kind, cached in (("partitioned_nc_live", "fp32", False),
                               ("partitioned_nc_cached_q8", "int8", True)):
        _build.reset_launches()
        trainer = nc(nc_model(torch.bfloat16), kind, cached)
        mesh.reset_counts()
        nc_kernels = ("sample_uniform", "gather_rows", "masked_reduce",
                      "masked_reduce_bwd", "route_requests", "unroute_rows")
        ms_step, losses, per_step, a2a, prof, state = run(
            path, trainer, nodes,
            nc_kernels + (("unroute_rows_q8",) if cached else ()))
        nsteps = PART_WARMUP + PART_STEPS
        acc = trainer.evaluate([np.arange(0, N, 7)])
        emit({"phase": "partitioned_nc_train_throughput", "rows": kind,
              "cached": cached, "shards": shards, "steps": PART_STEPS,
              "ms_per_step": ms_step,
              "seeds_per_s": BATCH / (ms_step / 1e3),
              "launches_per_step": per_step,
              "a2a_bytes_per_step": a2a / nsteps,
              "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
              "accuracy_every_7th_node": acc, "profile": prof, "card": card})
        del state
    path = "partitioned_nc_inference"
    sink = Sink()
    mesh.reset_counts()
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    total = run_partitioned_inference(trainer, N, sink,
                                      InferenceConfig(batch_size=BATCH))
    torch.cuda.synchronize()
    inf_s = time.perf_counter() - t0
    n_batches = -(-N // BATCH)
    counts[path] = (dict(_build.launches), n_batches)
    emit({"phase": "main_path", "path": path, "launches": counts[path][0],
          "batches": n_batches, "seconds": inf_s})
    for k in ("gather_rows", "masked_reduce", "route_requests",
              "unroute_rows", "unroute_rows_q8"):
        check(counts[path][0][k] > 0, f"{k} was not launched on {path}")
    logits = sink.table(N, C, path)
    check(total == N, f"{path}: {total} rows exported")
    with torch.inference_mode(), plain_kernels():
        ref0 = trainer.predict_batch(np.arange(BATCH, dtype=np.int32))
    err0 = float(np.abs(logits[:BATCH] - ref0.float().cpu().numpy()).max())
    scale0 = float(ref0.float().abs().max())
    # bf16 logits: one rounding of K4's fp32 sum against its twin's (a
    # bf16 ulp is 2**-8 of the value)
    check(err0 <= 1e-2 * scale0, f"{path}: batch 0 differs from the plain "
          f"recomputation: {err0} (scale {scale0})")
    emit({"phase": "partitioned_nc_inference_throughput", "nodes": N,
          "nodes_per_s": N / inf_s, "ms_per_batch": inf_s / n_batches * 1e3,
          "launches_per_batch": {k_: v_ / n_batches for k_, v_ in
                                 counts[path][0].items() if v_},
          "a2a_bytes_per_batch": mesh.a2a_bytes / n_batches,
          "batch0_max_abs_err": err0, "scale": scale0, "card": card})
    del trainer, graphs, tabs, mesh

    # -- one shard: the int8 cached NALP path's closed forms (K3's expand
    # mode through the tables, K12's packed-row mode for every union)
    path = "partitioned_cached_q8_one_shard"
    one = make_mesh(1)
    pg1 = PartitionedGraph.build(dg, one, quantize_features=True)
    _build.reset_launches()
    trainer = PartitionedNALPTrainer(
        make_model(), pg1, one, NALPTrainerConfig(**base),
        optimizer_args=opt_args, capacity_factor=PART_CAPACITY,
        overflow_policy="raise")
    state = trainer.init_state(0)
    built = dict(_build.launches)
    state, losses = trainer.train_steps(state, anchors[:PART_WARMUP + 5])
    torch.cuda.synchronize()
    counts[path] = (dict(_build.launches), PART_WARMUP + 5)
    per_step = {k_: (v_ - built[k_]) / (PART_WARMUP + 5)
                for k_, v_ in counts[path][0].items() if v_ - built[k_]}
    emit({"phase": "main_path", "path": path, "launches": counts[path][0],
          "steps": PART_WARMUP + 5, "launches_per_step": per_step})
    check(per_step.get("gather_rows_q8_packed") == 1
          and per_step.get("route_requests", 0) == 0
          and counts[path][0]["gather_rows"] > 0,
          f"{path}: not one K12 packed-row gather a step: {per_step}")
    check(np.isfinite(losses.float().cpu().numpy()).all(),
          f"{path}: loss not finite")
    del trainer, state, pg1
    return counts


def partitioned_label_edge_phases(dev, card, graph, edges, typed_ctx,
                                  add_mode, unique, opt_args):
    """Phase 19 (see the module docstring): (a) the label-edge features
    on the partitioned flagship graph, both pools, K16 carrying the edge
    rows and K17's own-block bias mode; (b) the typed partitioned trainer
    (PartitionedHeteroNALPTrainer) on phase 10's typed graph and the typed
    run_partitioned_inference. Returns {path: (launch counts, steps or
    passes)}; K16's edge rows and K17's bias mode land on their kernels'
    rows as modes."""
    from gigl_tpu_torch.inference.inferencer import (
        InferenceConfig, node_batches, run_partitioned_inference)
    from gigl_tpu_torch.losses import sharded_retrieval as sr
    from gigl_tpu_torch.models.encoders import GNNEncoder
    from gigl_tpu_torch.models.link_prediction import (
        EdgeFeatureScorer, HeteroLinkPredictionGNN, LinkPredictionDecoder,
        LinkPredictionGNN)
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.parallel import feature_lookup as fl
    from gigl_tpu_torch.parallel.mesh import make_mesh
    from gigl_tpu_torch.training.dataset import DeviceGraph
    from gigl_tpu_torch.training.dist_hetero import (
        PartitionedHeteroGraph, PartitionedHeteroNALPTrainer)
    from gigl_tpu_torch.training.dist_sampled import (
        PartitionedGraph, PartitionedNALPTrainer)
    from gigl_tpu_torch.training.hetero_dataset import HeteroDeviceGraph
    from gigl_tpu_torch.training.hetero_trainer import HeteroNALPTrainerConfig
    from gigl_tpu_torch.training.trainer import NALPTrainerConfig
    from gigl_tpu_torch.types.graph import EdgeType

    k1, k2 = FANOUTS
    shards = PART_SHARDS
    counts = {}
    mesh = make_mesh(shards)

    def run(path, trainer, anchors, kernels, steps):
        """PART_WARMUP + ``steps`` steps with the launch counts reset just
        before and read just after (zero overflow checked), then
        LE_PROFILED profiled steps: (ms/step, losses, launches a step,
        all_to_all bytes a step, profile)."""
        state = trainer.init_state(0)
        gens = [torch.Generator(device=dev).manual_seed(s_)
                for s_ in range(shards)]
        mesh.reset_counts()
        _build.reset_launches()
        state, warm = trainer.train_steps(state, anchors[:PART_WARMUP], gens)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, losses = trainer.train_steps(
            state, anchors[PART_WARMUP: PART_WARMUP + steps], gens)
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t1) / steps * 1e3
        nsteps = PART_WARMUP + steps
        counts[path] = (dict(_build.launches), nsteps)
        emit({"phase": "main_path", "path": path,
              "launches": counts[path][0], "steps": nsteps})
        for k in kernels:
            check(counts[path][0][k] > 0, f"{k} was not launched on {path}")
        check(trainer.overflow_total == 0,
              f"{path}: {trainer.overflow_total} routed requests dropped")
        losses = losses.float().cpu().numpy()
        check(np.isfinite(losses).all() and np.isfinite(
            warm.float().cpu().numpy()).all(), f"{path}: loss not finite")
        a2a = mesh.a2a_bytes / nsteps
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            trainer.train_steps(state, anchors[nsteps: nsteps + LE_PROFILED],
                                gens)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t1) * 1e6
        per_step = {k_: v_ / nsteps for k_, v_ in counts[path][0].items()
                    if v_}
        return ms_step, losses, per_step, a2a, profile_summary(
            prof, LE_PROFILED, window_us, ms_step)

    # -- (a) the flagship graph with label-edge features (numpy seed 8):
    # EDGE_DE fp32 features on each of the E supervision edges and on
    # EDGE_HARD hard-negative edges
    erng = np.random.default_rng(8)
    src_np, dst_np = edges
    hard_np = np.stack([erng.integers(0, N, EDGE_HARD),
                        erng.integers(0, N, EDGE_HARD)])
    t0 = time.perf_counter()
    dg_le = DeviceGraph.from_hetero(
        graph, supervision_edges=np.stack([src_np, dst_np]),
        hard_neg_edges=hard_np,
        supervision_edge_features=erng.normal(size=(E, EDGE_DE)).astype(
            np.float32),
        hard_neg_edge_features=erng.normal(size=(EDGE_HARD, EDGE_DE)).astype(
            np.float32), device=dev)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pg = PartitionedGraph.build(dg_le, mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    emit({"phase": "label_edge_partitioned_graph", "graph_s": graph_s,
          "build_s": build_s, "shards": shards,
          "sup_edge_feats_bytes_per_shard": pg.sup_edge_feats[0].nbytes,
          "hard_edge_feats_bytes_per_shard": pg.hard_edge_feats[0].nbytes,
          "edge_features": [E, EDGE_DE], "hard_negative_edges": EDGE_HARD,
          "card": card})
    base = dict(fanouts=FANOUTS, num_positives=1, num_hard_negs=1,
                num_random_negs=R, loss_type="retrieval")

    def le_model(dtype):
        return LinkPredictionGNN(
            GNNEncoder(D, HID, OUT, num_layers=2, conv="graphsage",
                       dtype=dtype), LinkPredictionDecoder(),
            EdgeFeatureScorer(EDGE_DE, 32))

    def le_trainer(model, **kw):
        return PartitionedNALPTrainer(
            model, pg, mesh, NALPTrainerConfig(**base, **kw),
            optimizer_args=opt_args, capacity_factor=PART_CAPACITY,
            overflow_policy="raise")

    n_anchor = PART_WARMUP + LE_STEPS + LE_PROFILED
    anchors = (np.arange(BATCH * n_anchor) % N).astype(np.int32).reshape(
        n_anchor, BATCH)
    a0 = torch.as_tensor(anchors[0], device=dev)

    # the routed positives, hard negatives and their edge rows against the
    # replicated DeviceGraph's batch at the same step: ids and masks
    # bit-equal, the rows bit-equal at valid slots and zero at padded ones
    # (the replicated draw reads the anchor's first slot there)
    chk = le_trainer(le_model(torch.float32))
    for step in (0, n_anchor - 1):
        a_ = torch.as_tensor(anchors[step], device=dev)
        batches, ovf = chk._make_batches(chk._split(a_), step)
        rep = dg_le.sample_nalp_batch(a_, num_positives=1, num_hard_negs=1,
                                      num_random_negs=R, seed=0, step=step)
        check(int(ovf) == 0, f"label-edge batch {step}: {int(ovf)} dropped")
        for what, r_ids, r_mask, r_rows in (
                ("pos", rep.pos, rep.pos_mask, rep.pos_edge_feats),
                ("hard_neg", rep.hard_neg, rep.hard_neg_mask,
                 rep.hard_neg_edge_feats)):
            ids_ = torch.cat([getattr(b_, what) for b_ in batches])
            mask_ = torch.cat([getattr(b_, what + "_mask") for b_ in
                               batches])
            rows_ = torch.cat([b_.pos_edge_feats if what == "pos" else
                               b_.hard_neg_edge_feats for b_ in batches])
            check(torch.equal(ids_, r_ids) and torch.equal(mask_, r_mask)
                  and torch.equal(rows_[mask_], r_rows[r_mask])
                  and not bool(rows_[~mask_].any()),
                  f"label-edge batch {step}: the routed {what} rows differ "
                  "from the replicated batch's")
    emit({"phase": "label_edge_batch_checks", "steps": [0, n_anchor - 1],
          "bit_equal": True,
          "masked_positive_slots": int((~rep.pos_mask).sum())})
    del chk, batches, rep

    # one step of each pool (fp32, the scorer's gradients held too) against
    # the same step through the plain versions
    for pool in ("per_shard", "ring"):
        t_ = le_trainer(le_model(torch.float32),
                        global_candidate_pool=pool == "ring")
        t_.init_state(0)
        scorer = {f"edge_scorer.{n_}": p_ for n_, p_ in
                  t_.model.edge_scorer.named_parameters()}
        vs = step_vs_plain(t_.model.encoder, lambda: t_.loss_and_sketch(
            a0, 0)[0], _build.launches, extra=scorer)
        emit({"phase": "label_edge_partitioned_step_vs_plain", "pool": pool,
              **vs})
        check(vs["loss_rel_err"] <= 1e-5 and
              vs["max_grad_err_rel_to_scale"] <= 1e-4,
              f"partitioned {pool} step with label edges differs from the "
              f"plain step: {vs}")
    # K16's edge rows and K17's bias mode, recorded from the ring step
    with spy(fl, "unroute_rows",
             lambda a, k: tuple(x_.clone() for x_ in a)) as unroutes, \
            spy(sr, "ring_fold", lambda a, k: a) as folds, \
            spy(sr, "ring_block_bwd", lambda a, k: a) as bwds:
        t_.loss_and_sketch(a0, 0)[0].backward()
    torch.cuda.synchronize()
    del t_

    # -- K16 over the routed [P, C, 1, EDGE_DE] edge rows (shard 0's
    # positives), bit-equal to its twin. bytes: owner / pos / ok read, each
    # answered row read once, a row written a request. Yardstick:
    # index_select of the flat answers and where
    rows16 = [u_ for u_ in unroutes if u_[0].dim() == 4]
    check(len(rows16) == 2 * shards, f"K16: {len(rows16)} edge-row "
          f"unroutes in the ring step, not 2 a shard")
    back, owner, pos, ok = rows16[0]
    got16 = fl.unroute_rows(back, owner, pos, ok)
    check(torch.equal(got16, fl._unroute_plain(back, owner, pos, ok)),
          "K16 over the edge rows is not bit-equal to its twin")
    g16, cap16 = owner.numel(), back.shape[1]
    row_b = back.shape[2] * back.shape[3] * back.element_size()
    flat16 = back.reshape(shards * cap16, -1)
    at16 = (owner.long() * cap16 + pos.clamp(max=cap16 - 1).long())
    add_mode("unroute_rows", "edge_rows", {
        "err": 0.0, "answers": list(back.shape), "requests": g16,
        "row_bytes": row_b,
        "ms": cuda_ms(lambda: fl.unroute_rows(back, owner, pos, ok)),
        "plain_ms": cuda_ms(lambda: fl._unroute_plain(back, owner, pos, ok)),
        "bound_ms": bound_ms(g16 * 9 + int(ok.sum()) * row_b + g16 * row_b,
                             0)[0],
        "bound_by": "bytes",
        "library_ms": cuda_ms(lambda: torch.where(
            ok[:, None], flat16.index_select(0, at16), 0.0)),
        "library_call": "index_select of the flat answers, then where",
        "eager_ms": eager_ms(lambda: fl.unroute_rows(back, owner, pos, ok)),
        "of": "shard 0's positive edge rows in the ring step"})
    del unroutes, rows16

    # -- K17's own-block bias mode: shard 0's fold and backward (bias
    # terms e_pos [Ql], e_hard [B h]) against the twins (the dense bias
    # added to block 0, the terms' cotangents by autograd through it),
    # timed beside the dense add + K17's plain mode (no library) and
    # torch.logsumexp over the biased masked scores
    check(len(folds) == shards and len(bwds) == shards,
          f"K17: {len(folds)} folds and {len(bwds)} backward calls")
    sc, rws, cls, own, _, _, _, bias = folds[0]
    bsc, brw, bcl, bown, lse, gr, bbias = bwds[0]
    check(bias is not None and bias.e_pos is not None
          and bias.e_hard is not None, "K17: the ring step ran no bias mode")
    p17, ql, cl = sc.shape
    nh = bias.e_hard.shape[0]
    fresh = (torch.full((ql,), sr.FMIN, device=dev),
             torch.zeros(ql, device=dev), torch.zeros(ql, device=dev))
    got_state = [x_.clone() for x_ in fresh]
    want_state = [x_.clone() for x_ in fresh]
    sr.ring_fold(sc, rws, cls, own, *got_state, bias=bias)
    sr._ring_fold_plain(sc, rws, cls, own, *want_state, bias=bias)
    for g_, w_ in zip(got_state, want_state):
        torch.testing.assert_close(g_, w_, rtol=1e-5, atol=0)
    fold_err = max(float((g_ - w_).abs().max())
                   for g_, w_ in zip(got_state, want_state))
    k_out = sr.ring_block_bwd(bsc, brw, bcl, bown, lse, gr, bbias)
    p_out = sr._ring_block_bwd_plain(bsc, brw, bcl, bown, lse, gr, bbias)
    errs17 = {}
    for what, k_, p_ in zip(("ds", "de_pos", "de_hard"), k_out, p_out):
        scale_ = float(p_.abs().max())
        errs17[what] = float((k_ - p_).abs().max())
        check(errs17[what] <= 1e-5 * scale_, f"K17 bias mode {what} error "
              f"{errs17[what]} > 1e-5 * {scale_}")
    check(torch.equal(k_out[0], sr.ring_block_bwd(bsc, brw, bcl, bown, lse,
                                                  gr, bbias)[0]),
          "K17's bias-mode backward is not the same bits on a repeat run")
    work = [x_.clone() for x_ in fresh]
    b_ = sr.OwnBlockBias(bias.e_pos, bias.e_hard, bias.num_pos,
                         bias.num_hard)

    def dense_fold():
        sr.ring_fold(sr._with_bias(sc, b_), rws, cls, own, *work)

    def dense_bwd():
        ds_ = sr.ring_block_bwd(sr._with_bias(bsc, b_), brw, bcl, bown, lse,
                                gr)
        blk = ds_[0][:, ql:ql + nh].reshape(ql // b_.num_pos, b_.num_pos,
                                            ql // b_.num_pos, b_.num_hard)
        return torch.diagonal(ds_[0]), torch.diagonal(
            blk.sum(1), dim1=0, dim2=1).T.reshape(-1)

    v_all = torch.cat([sr._masked_block_plain(
        sr._with_bias(bsc, b_)[t_] if t_ == 0 else bsc[t_], brw,
        sr._block_cols(bcl, t_), bown and t_ == 0)[0]
        for t_ in range(p17)], 1)
    v_lib = v_all.detach().clone().requires_grad_()
    fold_ms = cuda_ms(lambda: sr.ring_fold(sc, rws, cls, own, *work,
                                           bias=bias))
    bwd_ms = cuda_ms(lambda: sr.ring_block_bwd(bsc, brw, bcl, bown, lse, gr,
                                               bbias))
    plain_fold_ms = cuda_ms(lambda: sr._ring_fold_plain(
        sc, rws, cls, own, *work, bias=bias))
    plain_bwd_ms = cuda_ms(lambda: sr._ring_block_bwd_plain(
        bsc, brw, bcl, bown, lse, gr, bbias))
    dense_fold_ms, dense_bwd_ms = cuda_ms(dense_fold), cuda_ms(dense_bwd)
    # K17's plain mode at the same shape over scores with the bias added
    # beforehand: what the bias mode costs over it
    biased, bbiased = sr._with_bias(sc, b_), sr._with_bias(bsc, b_)
    same = [x_.clone() for x_ in fresh]
    sr.ring_fold(biased, rws, cls, own, *same)
    same_bits = all(torch.equal(g_, w_) for g_, w_ in zip(got_state, same))
    plain_mode_fold_ms = cuda_ms(lambda: sr.ring_fold(biased, rws, cls, own,
                                                      *work))
    plain_mode_bwd_ms = cuda_ms(lambda: sr.ring_block_bwd(
        bbiased, brw, bcl, bown, lse, gr))
    cols_b = p17 * cl * 13
    rows_b = ql * 12
    bias_b = (ql + nh) * 4
    nbytes17 = (p17 * ql * cl * 4 + cols_b + rows_b + ql * 24 + bias_b) + (
        p17 * ql * cl * 8 + cols_b + rows_b + ql * 8 + 2 * bias_b)
    b17, by17 = bound_ms(nbytes17, p17 * ql * cl * 22)
    add_mode("ring_retrieval", "own_block_bias", {
        "err": max(fold_err, *errs17.values()), "fold_err": fold_err,
        **{f"{k_}_err": v_ for k_, v_ in errs17.items()},
        "blocks": [p17, ql, cl], "hard_columns": nh,
        "ms": fold_ms + bwd_ms, "fold_ms": fold_ms, "bwd_ms": bwd_ms,
        "plain_ms": plain_fold_ms + plain_bwd_ms,
        "plain_fold_ms": plain_fold_ms, "plain_bwd_ms": plain_bwd_ms,
        "plain_mode_fold_ms": plain_mode_fold_ms,
        "plain_mode_bwd_ms": plain_mode_bwd_ms,
        "fold_bit_equal_to_plain_mode_over_the_dense_add": same_bits,
        "dense_add_ms": dense_fold_ms + dense_bwd_ms,
        "dense_add_fold_ms": dense_fold_ms, "dense_add_bwd_ms": dense_bwd_ms,
        "bound_ms": b17, "bound_by": by17,
        "fold_bound_ms": bound_ms(p17 * ql * cl * 4 + cols_b + rows_b
                                  + ql * 24 + bias_b,
                                  p17 * ql * cl * 11)[0],
        "library_ms": cuda_ms(lambda: torch.autograd.grad(
            torch.logsumexp(v_lib, 1).sum(), v_lib)),
        "library_fold_ms": cuda_ms(lambda: torch.logsumexp(v_all, 1)),
        "library_call": "torch.logsumexp over the P biased masked blocks "
                        "side by side and its gradient (autograd.grad)",
        "eager_ms": eager_ms(lambda: sr.ring_fold(sc, rws, cls, own, *work,
                                                  bias=bias))})
    del folds, bwds, v_all, v_lib, work, k_out, p_out, biased, bbiased

    # -- the label-edge paths, both pools (bf16, the scorer's terms in the
    # loss, K17's bias mode on the ring)
    le_kernels = ("sample_uniform", "uniform_ids", "gather_rows",
                  "masked_reduce", "masked_reduce_bwd", "route_requests",
                  "unroute_rows")
    for path, pool in (("label_edge_partitioned_train", "per_shard"),
                       ("label_edge_partitioned_ring_train", "ring")):
        trainer = le_trainer(le_model(torch.bfloat16),
                             global_candidate_pool=pool == "ring")
        ms_step, losses, per_step, a2a, prof = run(
            path, trainer, anchors, le_kernels + (
                ("ring_retrieval", "ring_retrieval_bias") if pool == "ring"
                else ("retrieval_loss",)), LE_STEPS)
        if pool == "ring":
            check(per_step.get("ring_retrieval_bias") == 2 * shards
                  and per_step.get("ring_retrieval") == 2 * shards,
                  f"{path}: {per_step} — not a bias-mode fold and backward "
                  "launch a shard a step")
        emit({"phase": "label_edge_partitioned_train_throughput",
              "pool": pool, "shards": shards, "steps": LE_STEPS,
              "ms_per_step": ms_step, "seeds_per_s": BATCH / (ms_step / 1e3),
              "launches_per_step": per_step, "a2a_bytes_per_step": a2a,
              "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
              "profile": prof, "card": card})
        del trainer
    del pg, dg_le

    # -- (b) the typed partitioned trainer on phase 10's typed graph
    tgraph, tpaths, make_encoder, anchors_t = (
        typed_ctx["graph"], typed_ctx["paths"], typed_ctx["make_encoder"],
        typed_ctx["anchors"])
    writes = EdgeType.from_str(WRITES)
    n_writes = int(tgraph.edges[writes].shape[1])
    sup = dict(supervision_edge_type=writes,
               supervision_edges=tgraph.edges[writes],
               supervision_anchor="dst", device=dev)
    hdg = HeteroDeviceGraph.from_hetero(tgraph, tpaths, **sup)
    hdg_le = HeteroDeviceGraph.from_hetero(
        tgraph, tpaths, supervision_edge_features=erng.normal(
            size=(n_writes, EDGE_DE)).astype(np.float32), **sup)
    build = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tpg = PartitionedHeteroGraph.build(hdg, tpaths, mesh,
                                       anchor_node_type="paper")
    torch.cuda.synchronize()
    build["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tpg_tab = tpg.with_sample_tables(hdg, tpaths, mesh, seed=0)
    torch.cuda.synchronize()
    build["with_sample_tables_s"] = time.perf_counter() - t0
    tpg_le = PartitionedHeteroGraph.build(hdg_le, tpaths, mesh,
                                          anchor_node_type="paper")
    emit({"phase": "typed_partitioned_graph", **build, "shards": shards,
          "rows": tpg.rows, "csrs": sorted(tpg.csr_ip),
          "feature_bytes_per_shard": {nt: f_[0].nbytes
                                      for nt, f_ in tpg.feats.items()},
          "table_bytes_per_shard": sum(t_[0].nbytes for t_ in
                                       tpg_tab.sample_tables.values()),
          "card": card})
    tcfg = dict(anchor_node_type="paper", candidate_node_type="author",
                num_positives=1, num_hard_negs=0, num_random_negs=R,
                loss_type="retrieval", temperature=0.07)
    rep_tab = hdg.with_sample_tables(tpaths, seed=0)
    per_root = {}
    for nt, spec in tpaths.items():          # as phase 10 counts them
        slots = []
        for op in spec:
            slots.append(op.fanout * (1 if op.parent < 0
                                      else slots[op.parent]))
        per_root[nt] = sum(k_ * max(0, 3 - op.depth)
                           for k_, op in zip(slots, spec))
    edges_step = per_root["paper"] * BATCH + per_root["author"] * (BATCH + R)
    symmetric = {"hgt": ("encoder.convs.1.a_author.bias",), "rgcn": ()}
    typed_paths = {
        "typed_partitioned_hgt_live": ("hgt", tpg, hdg, {}),
        "typed_partitioned_hgt_tabularized": (
            "hgt", tpg_tab, rep_tab, {"tabularized": True}),
        "typed_partitioned_rgcn_ring_label_edges": (
            "rgcn", tpg_le, hdg_le, {"global_candidate_pool": True})}
    t_anchor = PART_WARMUP + LE_STEPS + LE_PROFILED
    a0_t = torch.as_tensor(anchors_t[0], device=dev)
    inf_trainer = None
    for path, (conv, pgx, repx, extra) in typed_paths.items():
        scorer = "label_edges" in path

        def typed_trainer(conv=conv, pgx=pgx, extra=extra, scorer=scorer):
            return PartitionedHeteroNALPTrainer(
                HeteroLinkPredictionGNN(
                    make_encoder(conv), LinkPredictionDecoder(),
                    EdgeFeatureScorer(EDGE_DE, 32) if scorer else None),
                pgx, tpaths, HeteroNALPTrainerConfig(**tcfg, **extra), mesh,
                optimizer_args={"learning_rate": "1e-3"},
                capacity_factor=PART_CAPACITY, overflow_policy="raise")

        tr = typed_trainer()
        tr.init_state(0)
        # the routed trees of both node types against the replicated draws
        # (HeteroNALPTrainer's: graph.sample keyed by cfg.seed + offset, or
        # the replicated frozen tables)
        for nt, n_ in (("paper", HET_PAPERS), ("author", HET_AUTHORS)):
            roots = torch.as_tensor(anchors_t[1] % n_, device=dev)
            trees, ovf = tr._sample_tree(list(roots.reshape(shards, -1)), nt,
                                         1)
            want = (repx.sample_tabularized(roots, nt, tpaths[nt])
                    if "tabularized" in extra else
                    repx.sample(roots, nt, tpaths[nt], seed=1))
            check(int(ovf) == 0 and all(
                torch.equal(torch.cat([t_.node_ids[l_] for t_ in trees]),
                            want.node_ids[l_])
                and torch.equal(torch.cat([t_.masks[l_] for t_ in trees]),
                                want.masks[l_])
                for l_ in range(len(tpaths[nt]) + 1)),
                f"{path}: the routed {nt} tree differs from the replicated "
                "draw")
        vs = step_vs_plain(tr.model, lambda: tr.loss_and_overflow(
            a0_t, 0)[0], _build.launches, gated=False,
            symmetric=symmetric[conv])
        emit({"phase": "typed_partitioned_step_vs_plain", "path": path,
              **vs})
        check(vs["loss_rel_err"] <= 1e-5 and
              vs["max_grad_err_rel_to_scale"] <= 1e-4,
              f"{path}: the step differs from the plain step: {vs}")
        del tr
        kernels = ("sample_uniform", "uniform_ids", "gather_rows",
                   "route_requests", "unroute_rows") + (
            ("fanout_attention", "fanout_attention_bwd") if conv == "hgt"
            else ("masked_reduce", "masked_reduce_bwd")) + (
            ("ring_retrieval", "ring_retrieval_bias")
            if extra.get("global_candidate_pool") else ("retrieval_loss",))
        trainer = typed_trainer()
        ms_step, losses, per_step, a2a, prof = run(
            path, trainer, anchors_t[:t_anchor], kernels, LE_STEPS)
        emit({"phase": "typed_partitioned_train_throughput", "path": path,
              "model": conv, "shards": shards, "steps": LE_STEPS,
              "ms_per_step": ms_step, "edges_per_step": edges_step,
              "edges_per_s": edges_step / (ms_step / 1e3),
              "launches_per_step": per_step, "a2a_bytes_per_step": a2a,
              "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
              "profile": prof, "card": card})
        if "tabularized" in extra:
            inf_trainer = trainer
        else:
            del trainer

    # -- run_partitioned_inference(node_type=) through the tabularized HGT
    # trainer, both node types; each exported row against encode_batch's
    # for the same batch of ids
    for nt, n_ in (("paper", HET_PAPERS), ("author", HET_AUTHORS)):
        path = f"typed_partitioned_inference_{nt}"
        sink = Sink()
        cfg_i = InferenceConfig(batch_size=BATCH)
        mesh.reset_counts()
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total = run_partitioned_inference(inf_trainer, n_, sink, cfg_i,
                                          node_type=nt)
        torch.cuda.synchronize()
        inf_s = time.perf_counter() - t0
        n_batches = -(-n_ // BATCH)
        counts[path] = (dict(_build.launches), n_batches)
        emit({"phase": "main_path", "path": path,
              "launches": counts[path][0], "batches": n_batches,
              "seconds": inf_s})
        for k in ("gather_rows", "route_requests", "unroute_rows",
                  "fanout_attention"):
            check(counts[path][0][k] > 0, f"{k} was not launched on {path}")
        check(total == n_, f"{path}: {total} rows exported")
        embs = sink.table(n_, HET_OUT, path)
        err, scale_ = 0.0, 0.0
        with torch.inference_mode():
            for ids_, valid in node_batches(n_, cfg_i):
                ref = inf_trainer.encode_batch(ids_, nt)[:valid].float()
                ref = ref.cpu().numpy()
                err = max(err, float(np.abs(embs[ids_[:valid]] - ref).max()))
                scale_ = max(scale_, float(np.abs(ref).max()))
        check(err <= 1e-6 * scale_, f"{path}: the exported rows differ "
              f"from encode_batch's: {err} (scale {scale_})")
        emit({"phase": "typed_partitioned_inference_throughput",
              "node_type": nt, "nodes": n_, "nodes_per_s": n_ / inf_s,
              "ms_per_batch": inf_s / n_batches * 1e3,
              "launches_per_batch": {k_: v_ / n_batches for k_, v_ in
                                     counts[path][0].items() if v_},
              "a2a_bytes_per_batch": mesh.a2a_bytes / n_batches,
              "max_abs_err_vs_encode_batch": err, "scale": scale_,
              "card": card})
    del inf_trainer, tpg, tpg_tab, tpg_le, hdg, hdg_le, rep_tab, mesh
    return counts


def streaming_phases(dev, card, arrays, dg):
    """Phase 20 (see the module docstring): out-of-core NALP training over
    a HostGraphStore whose features lie in an np.memmap on local disk.
    Returns {path: (launch counts, steps)}."""
    from gigl_tpu_torch import native
    from gigl_tpu_torch.models.encoders import GNNEncoder
    from gigl_tpu_torch.models.link_prediction import (
        LinkPredictionDecoder, LinkPredictionGNN)
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.training.streaming import (
        HostGraphStore, StreamingNALPTrainer)
    from gigl_tpu_torch.training.trainer import (
        NALPTrainer, NALPTrainerConfig)

    src_np, dst_np, x_np = arrays
    t0 = time.perf_counter()
    native.build()
    engine_s = time.perf_counter() - t0
    path = REPO / "build" / "streaming" / "features.f32"
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    np.ascontiguousarray(x_np, np.float32).tofile(path)
    mm = np.memmap(path, dtype=np.float32, mode="r", shape=(N, D))
    write_s = time.perf_counter() - t0
    cfg = NALPTrainerConfig(fanouts=FANOUTS, num_random_negs=R,
                            loss_type="retrieval", num_positives=1,
                            cached_hop=True)
    opt = {"learning_rate": "1e-3"}
    edges = np.stack([src_np, dst_np])
    t0 = time.perf_counter()
    store = HostGraphStore.build(message_edges=edges,
                                 supervision_edges=edges, features=mm,
                                 num_nodes=N, fanouts=FANOUTS, seed=cfg.seed)
    store_s = time.perf_counter() - t0
    check(isinstance(store.features.array, np.memmap)
          or isinstance(store.features.array.base, np.memmap),
          "the streamed features were copied off the memmap")

    def model(dtype):
        return LinkPredictionGNN(
            GNNEncoder(D, HID, OUT, num_layers=2, conv="graphsage",
                       dtype=dtype), LinkPredictionDecoder())

    # the host tables against the device-resident tabularized ones (K1's
    # frozen draws bit-equal; the aggregate against K2's, fp32 sums of the
    # same rows in another order), then three fp32 steps against the
    # device-resident trainer's from the same weights
    dres = NALPTrainer(model(torch.float32), dg, cfg, optimizer_args=opt,
                       device=dev)
    packed = dres.graph.sample_tables[FANOUTS[0]].cpu().numpy()
    ids_t, mask_t = store.sample_tables[FANOUTS[0]]
    check(np.array_equal(packed >= 0, mask_t) and np.array_equal(
        np.where(packed >= 0, packed, 0), np.where(mask_t, ids_t, 0)),
        "the host sample table is not the device-resident one")
    cache = dres.graph.nbr_cache.cpu().numpy()
    agg_err = float(np.abs(store.agg.array - cache).max())
    check(agg_err <= 1e-5 * float(np.abs(cache).max()),
          f"the host hop-cache aggregate is {agg_err} from K2's")
    ds = dres.init_state(0)
    params = {k: v.clone() for k, v in dres.model.state_dict().items()}
    n_anchor = STREAM_WARMUP + STREAM_STEPS + STREAM_PROFILED
    anchors = (np.arange(BATCH * n_anchor) % N).astype(np.int32).reshape(
        n_anchor, BATCH)
    s32 = StreamingNALPTrainer(model(torch.float32), store, cfg,
                               optimizer_args=opt, device=dev)
    _, ld = dres.train_steps(ds, anchors[:STREAM_PARITY_STEPS])
    _, ls = s32.run_steps(s32.init_state(params=params),
                          anchors[:STREAM_PARITY_STEPS])
    ld = ld.cpu().numpy()
    loss_err = float((np.abs(ls - ld) / np.abs(ld)).max())
    check(loss_err <= 1e-4, f"streamed losses {ls} differ from the "
          f"device-resident trainer's {ld}")
    emit({"phase": "streaming_store", "memmap_write_s": write_s,
          "engine_build_s": engine_s, "store_build_s": store_s,
          "feature_bytes": N * D * 4, "agg_max_abs_err_vs_k2": agg_err,
          "losses_streamed": ls.tolist(), "losses_device_resident":
              ld.tolist(), "loss_rel_err": loss_err})
    del dres, ds, s32, cache

    # the flagship path (bf16 model), fp32 and bf16 streams in turns
    # (A B B A): launches, host and device ms, the copy
    counts, turns = {}, []
    for turn, sd in enumerate(("float32", "bfloat16", "bfloat16",
                               "float32")):
        tr = StreamingNALPTrainer(model(torch.bfloat16), store, cfg,
                                  optimizer_args=opt, stream_dtype=sd,
                                  device=dev)
        st = tr.init_state(0)
        st, _ = tr.run_steps(st, anchors[:STREAM_WARMUP],
                             prefetch=STREAM_PREFETCH)
        torch.cuda.synchronize()
        lo = STREAM_WARMUP
        _build.reset_launches()
        t0 = time.perf_counter()
        st, losses = tr.run_steps(st, anchors[lo: lo + STREAM_STEPS],
                                  start_step=lo, prefetch=STREAM_PREFETCH,
                                  timing=True)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / STREAM_STEPS * 1e3
        run = dict(tr.last_run)
        check(np.isfinite(losses).all(), f"streaming {sd}: loss not finite")
        row = {"stream_dtype": sd, "turn": turn, "ms_per_step": host_ms,
               "fill_ms_median": float(np.median(run["fill_s"])) * 1e3,
               "streamed_bytes_per_step": run["bytes_per_step"],
               "copy_ms": run["copy_ms"],
               "copy_gb_per_s": run["bytes_per_step"] / float(
                   np.median(run["copy_ms"])) / 1e6,
               "loss_first": float(losses[0]),
               "loss_last": float(losses[-1]), "losses": losses}
        if turn < 2:
            path_ = f"streaming_train_{sd}"
            counts[path_] = (dict(_build.launches), STREAM_STEPS)
            emit({"phase": "main_path", "path": path_,
                  "launches": counts[path_][0], "steps": STREAM_STEPS})
            for k in STREAM_KERNELS:
                check(counts[path_][0][k] > 0,
                      f"{k} was not launched on {path_}")
            for k in STREAM_ABSENT:
                check(counts[path_][0][k] == 0, f"{path_} launched {k}: "
                      "a row was drawn or gathered on the card")
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                hi = STREAM_WARMUP + STREAM_STEPS
                tr.run_steps(st, anchors[hi: hi + STREAM_PROFILED],
                             start_step=hi, prefetch=STREAM_PREFETCH)
                torch.cuda.synchronize()
                window_us = (time.perf_counter() - t0) * 1e6
            row["profile"] = profile_summary(prof, STREAM_PROFILED,
                                             window_us, host_ms)
            copies = [e for e in prof.events() if "Memcpy HtoD" in e.name]
            row["profile"]["copy_ms_per_step"] = sum(
                e.time_range.elapsed_us() for e in copies) / (
                    STREAM_PROFILED * 1e3)
        turns.append(row)
        emit({"phase": "streaming_train_throughput", "card": card,
              **{k: v for k, v in row.items() if k != "losses"}})
        del tr, st
    by = {sd: [r_["ms_per_step"] for r_ in turns
               if r_["stream_dtype"] == sd] for sd in ("float32",
                                                       "bfloat16")}
    emit({"phase": "streaming_fp32_vs_bf16", "ms_per_step": by,
          "streamed_bytes_per_step": {
              r_["stream_dtype"]: r_["streamed_bytes_per_step"]
              for r_ in turns},
          "copy_gb_per_s": {r_["stream_dtype"]: r_["copy_gb_per_s"]
                            for r_ in turns[:2]},
          # the same 50 steps from the same weights: bf16 rows against fp32
          "bf16_vs_fp32_loss_max_rel_diff": float(np.max(
              np.abs(turns[1]["losses"] - turns[0]["losses"])
              / np.abs(turns[0]["losses"]))), "card": card})
    mm._mmap.close()
    path.unlink()
    return counts


def streamed_partitioned_phases(dev, card, arrays, dg, typed_ctx, add_mode):
    """Phase 21 (see the module docstring): the streamed-partitioned tier
    on one card over PART_SHARDS shards, every feature row on the host.
    Returns {path: (launch counts, steps)}; K16 over the streamed answers
    lands on its kernel's row as a mode."""
    import warnings

    from gigl_tpu_torch import native
    from gigl_tpu_torch.models.encoders import GNNEncoder
    from gigl_tpu_torch.models.link_prediction import (
        HeteroLinkPredictionGNN, LinkPredictionDecoder, LinkPredictionGNN)
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.parallel import feature_lookup as fl
    from gigl_tpu_torch.parallel.mesh import make_mesh
    from gigl_tpu_torch.training.dist_hetero import (
        PartitionedHeteroGraph, PartitionedHeteroNALPTrainer)
    from gigl_tpu_torch.training.dist_sampled import (
        PartitionedGraph, PartitionedNALPTrainer,
        PartitionedNodeClassificationTrainer)
    from gigl_tpu_torch.training.hetero_dataset import HeteroDeviceGraph
    from gigl_tpu_torch.training.hetero_trainer import HeteroNALPTrainerConfig
    from gigl_tpu_torch.training.streaming import HostGraphStore
    from gigl_tpu_torch.training.streaming_partitioned import (
        ShardedHostStore, StreamingPartitionedHeteroNALPTrainer,
        StreamingPartitionedNALPTrainer,
        StreamingPartitionedNodeClassificationTrainer)
    from gigl_tpu_torch.training.trainer import (
        NALPTrainerConfig, NodeClassificationTrainerConfig)
    from gigl_tpu_torch.types.graph import EdgeType

    src_np, dst_np, x_np, labels_np = arrays
    shards, k1, k2 = PART_SHARDS, *FANOUTS
    mesh = make_mesh(shards)
    counts = {}
    native.build()
    cfg = NALPTrainerConfig(fanouts=FANOUTS, num_random_negs=R,
                            loss_type="retrieval", num_positives=1,
                            cached_hop=True)
    opt = {"learning_rate": "1e-3"}
    edges = np.stack([src_np, dst_np])
    t0 = time.perf_counter()
    store = HostGraphStore.build(message_edges=edges,
                                 supervision_edges=edges, features=x_np,
                                 num_nodes=N, fanouts=FANOUTS, seed=cfg.seed,
                                 node_labels=labels_np)
    store_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = ShardedHostStore.from_host_store(store, num_shards=shards)
    host_s = time.perf_counter() - t0

    def model(dtype):
        return LinkPredictionGNN(
            GNNEncoder(D, HID, OUT, num_layers=2, conv="graphsage",
                       dtype=dtype), LinkPredictionDecoder())

    def streamed(m, answer_dtype="float32"):
        return StreamingPartitionedNALPTrainer(
            m, store, mesh, cfg, batch_size=BATCH, optimizer_args=opt,
            capacity_factor=PART_CAPACITY, overflow_policy="raise",
            host_store=host, answer_dtype=answer_dtype)

    def no_float_rows(gathered, path):
        """The card's K3 gathers on the path read integer tables only (the
        frozen sample tables): no feature row was gathered there."""
        check(all(dt_ == torch.int32 for dt_, _ in gathered),
              f"{path}: a float row was gathered on the card: "
              f"{sorted(set(gathered))}")

    def timed(path, tr, state, batches, warmup, steps, kernels,
              profiled=0, gens=None, pipeline=True):
        """``warmup`` then ``steps`` steps of the pipelined (or sequential)
        schedule with the launch counts, all_to_all bytes and K3 gathers
        recorded over the latter (timing on), then ``profiled`` profiled
        steps: (state, row)."""
        state, _ = tr.run_steps(state, list(batches[:warmup]), gens,
                                pipeline=pipeline)
        torch.cuda.synchronize()
        mesh.reset_counts()
        _build.reset_launches()
        with spy(fl, "gather_rows", lambda a, k: (
                a[0].dtype, tuple(a[0].shape[1:]))) as gathered:
            t1 = time.perf_counter()
            state, losses = tr.run_steps(
                state, list(batches[warmup: warmup + steps]), gens,
                timing=True, pipeline=pipeline)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t1) / steps * 1e3
        counts[path] = (dict(_build.launches), steps)
        emit({"phase": "main_path", "path": path,
              "launches": counts[path][0], "steps": steps})
        for k in kernels:
            check(counts[path][0][k] > 0, f"{k} was not launched on {path}")
        no_float_rows(gathered, path)
        check(tr.overflow_total == 0,
              f"{path}: {tr.overflow_total} routed requests dropped")
        check(np.isfinite(losses).all(), f"{path}: loss not finite")
        run = tr.last_run
        requested, slot_rows = tr.answer_slot_rows()
        copy_ms = float(np.median(run["copy_ms"]))
        row = {"path": path, "steps": steps, "ms_per_step": host_ms,
               "host_gather_ms_median": float(
                   np.median(run["gather_s"])) * 1e3,
               "recv_wait_ms_median": float(np.median(run["wait_s"])) * 1e3,
               "answer_bytes_per_step": run["answer_bytes"][0],
               "copy_ms_median": copy_ms,
               "copy_gb_per_s": run["answer_bytes"][0] / copy_ms / 1e6,
               "a2a_bytes_per_step": mesh.a2a_bytes / steps,
               "rows_requested_per_step": requested,
               "answer_slot_rows_per_step": slot_rows,
               "answer_slot_padding_share": 1 - requested / slot_rows,
               "launches_per_step": {k_: v_ / steps for k_, v_
                                     in counts[path][0].items() if v_},
               "loss_first": float(losses[0]),
               "loss_last": float(losses[-1]), "losses": losses}
        if profiled:
            lo = warmup + steps
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                tr.run_steps(state, list(batches[lo: lo + profiled]), gens,
                             pipeline=pipeline)
                torch.cuda.synchronize()
                window_us = (time.perf_counter() - t1) * 1e6
            row["profile"] = profile_summary(prof, profiled, window_us,
                                             host_ms)
            row["device_ms_per_step"] = row["profile"].get(
                "device_ms_per_step")
            row["busy_share"] = row["profile"].get(
                "busy_share_of_unprofiled_step")
        return state, row

    # -- (a) fp32: the tables, draws and recv ids, and three steps against
    # the device-resident cached trainer from the same weights; the
    # sequential and the pipelined schedules bit for bit
    n_anchor = SP_PARITY + SP_WARMUP + SP_STEPS + SP_PROFILED
    anchors = (np.arange(BATCH * n_anchor) % N).astype(np.int32).reshape(
        n_anchor, BATCH)
    dres = PartitionedNALPTrainer(model(torch.float32),
                                  PartitionedGraph.build(dg, mesh), mesh,
                                  cfg, optimizer_args=opt,
                                  capacity_factor=PART_CAPACITY,
                                  overflow_policy="raise")
    ds = dres.init_state(0)
    params = {k: v.clone() for k, v in dres.model.state_dict().items()}
    seq = streamed(model(torch.float32))
    ss = seq.init_state(params=params)
    check(all(torch.equal(torch.cat(a_), torch.cat(b_)) for a_, b_ in zip(
        seq.pg.sample_tables, dres.pg.sample_tables)),
        "the host store's frozen tables are not the device-resident ones")
    plan = seq._plan(anchors[0], 0)
    batches, _ = dres._make_batches(dres._split(dres._ids(anchors[0])), 0)
    trees, _ = dres._draw_trees(dres._groups(batches, False))
    cap = seq._capacity(seq._union_sizes(False)[0])
    recv, _ = fl.send_requests(
        mesh, [dres._union_ids(trees, s) for s in range(shards)],
        seq.pg.rows_per_shard, cap)
    check(all(torch.equal(a_.pos, b_.pos) and torch.equal(
        a_.random_neg, b_.random_neg) for a_, b_ in zip(plan.ctx[0],
                                                        batches)),
          "the streamed draws differ from the device-resident trainer's")
    check(torch.equal(torch.stack(recv), plan.recvs[0]),
          "the streamed plan's recv ids differ from the device-resident "
          "trainer's union routed at the same capacity")
    # K16 over shard 0's streamed answers of this plan, fp32 and bf16: the
    # fused row is 2D + 1 values (1,028 or 514 bytes), so K16 moves 4- or
    # 2-byte words. bytes: each request's owner, pos and ok, each kept
    # request's answer row read, every output row written
    answers = seq._host(plan)
    back = mesh.all_to_all(list(answers[0]))[0]
    owner, pos, ok = plan.coords[0][0]
    at = owner.long() * back.shape[1] + pos.long().clamp(
        max=back.shape[1] - 1)
    k16 = {"of": "shard 0's answers of the streamed plan at step 0"}
    for kind, b_ in (("fp32", back), ("bf16", back.to(torch.bfloat16))):
        flat = b_.reshape(-1, b_.shape[-1])
        row_b = b_.shape[-1] * b_.element_size()
        check(torch.equal(fl.unroute_rows(b_, owner, pos, ok),
                          fl._unroute_plain(b_, owner, pos, ok)),
              f"K16 over the streamed {kind} answers differs from its twin")
        k16[kind] = {
            "err": 0.0, "answers": list(b_.shape), "requests": ok.numel(),
            "row_bytes": row_b, "word_bytes": 4 if row_b % 4 == 0 else 2,
            "ms": cuda_ms(lambda b_=b_: fl.unroute_rows(b_, owner, pos, ok)),
            "plain_ms": cuda_ms(
                lambda b_=b_: fl._unroute_plain(b_, owner, pos, ok)),
            "bound_ms": bound_ms(ok.numel() * 9 + int(ok.sum()) * row_b
                                 + ok.numel() * row_b, 0)[0],
            "bound_by": "bytes",
            "library_ms": cuda_ms(lambda flat=flat: torch.where(
                ok[:, None], flat.index_select(0, at), 0)),
            "library_call": "index_select of the flat answers, then where"}
    add_mode("unroute_rows", "streamed_answers", k16)
    seq._unroute(plan, answers)
    del plan, batches, trees, recv, answers, back
    ds, ld = dres.train_steps(ds, anchors[:SP_PARITY])
    ld = ld.cpu().numpy()
    ls = []
    for a_ in anchors[:SP_PARITY]:
        ss, l_ = seq.train_step(ss, a_)
        ls.append(float(l_))
    ls = np.asarray(ls, np.float32)
    pipe = streamed(model(torch.float32))
    _, lp = pipe.run_steps(pipe.init_state(params=params),
                           list(anchors[:SP_PARITY]))
    loss_err = float(np.max(np.abs(ls - ld) / np.abs(ld)))
    check(np.array_equal(ls, lp), f"the pipelined losses {lp} are not the "
          f"sequential schedule's {ls}")
    check(loss_err <= 1e-5, f"streamed losses {ls} differ from the "
          f"device-resident trainer's {ld}")
    emit({"phase": "streamed_partitioned_parity", "shards": shards,
          "store_build_s": store_s, "sharded_host_store_s": host_s,
          "host_store_bytes": host.table.nbytes, "row_bytes_fp32":
              host.width * 4, "answer_capacity": cap,
          "losses_sequential": ls.tolist(), "losses_pipelined": lp.tolist(),
          "losses_device_resident": ld.tolist(), "loss_rel_err": loss_err,
          "card": card})
    del dres, ds, seq, ss, pipe

    # -- (b) the flagship (bf16 model): fp32 and bf16 answers in turns
    # (A B B A), each turn both schedules (the order alternating); the first
    # run's first two steps under sync debug mode "warn"
    edges_step = (2 * k1 + k1 * k2) * (BATCH + BATCH + R)
    tr = streamed(model(torch.bfloat16))
    tr.sync_debug_mode = "warn"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tr.run_steps(tr.init_state(0), list(anchors[:2]))
    syncs = sorted({str(w_.message)[:160] for w_ in caught
                    if "synchroniz" in str(w_.message)})
    del tr
    runs = []
    for turn, ad in enumerate(("float32", "bfloat16", "bfloat16",
                               "float32")):
        for sched in (("pipelined", "sequential") if turn % 2 == 0
                      else ("sequential", "pipelined")):
            tr = streamed(model(torch.bfloat16), ad)
            st = tr.init_state(0)
            path = f"streamed_partitioned_{ad}_{sched}" + (
                "_repeat" if turn >= 2 else "")
            st, row = timed(path, tr, st, anchors[SP_PARITY:], SP_WARMUP,
                            SP_STEPS, SP_KERNELS, profiled=SP_PROFILED,
                            pipeline=sched == "pipelined")
            row.update({"answer_dtype": ad, "schedule": sched, "turn": turn,
                        "shards": shards, "edges_per_step": edges_step,
                        "edges_per_s": edges_step / (row["ms_per_step"]
                                                     / 1e3)})
            if not runs:
                row["implicit_syncs_in_plan_and_apply"] = syncs
            if turn >= 2:
                counts.pop(path)   # launch counts: each pair's first turn
            runs.append(row)
            emit({"phase": "streamed_partitioned_train_throughput",
                  "card": card,
                  **{k: v for k, v in row.items() if k != "losses"}})
            del tr, st
    first = {(r_["answer_dtype"], r_["schedule"]): r_ for r_ in runs
             if r_["turn"] < 2}
    emit({"phase": "streamed_partitioned_schedules_and_dtypes",
          "card": card,
          "ms_per_step": {f"{ad}_{sc}": [r_["ms_per_step"] for r_ in runs
                                         if (r_["answer_dtype"],
                                             r_["schedule"]) == (ad, sc)]
                          for ad, sc in first},
          "answer_bytes_per_step": {ad: first[(ad, "pipelined")][
              "answer_bytes_per_step"] for ad in ("float32", "bfloat16")},
          # the same steps from the same weights: the schedules bit for bit,
          # bf16 answers against fp32
          "repeat_equal": {f"{ad}_{sc}": bool(np.array_equal(*[
              r_["losses"] for r_ in runs
              if (r_["answer_dtype"], r_["schedule"]) == (ad, sc)]))
              for ad, sc in first},
          "schedules_equal": {ad: bool(np.array_equal(
              first[(ad, "pipelined")]["losses"],
              first[(ad, "sequential")]["losses"]))
              for ad in ("float32", "bfloat16")},
          "bf16_vs_fp32_loss_max_rel_diff": float(np.max(
              np.abs(first[("bfloat16", "pipelined")]["losses"]
                     - first[("float32", "pipelined")]["losses"])
              / np.abs(first[("float32", "pipelined")]["losses"])))})
    for ad in ("float32", "bfloat16"):
        check(np.array_equal(first[(ad, "pipelined")]["losses"],
                             first[(ad, "sequential")]["losses"]),
              f"{ad} answers: the pipelined and the sequential schedules' "
              "losses differ")

    # -- (c) the typed trainer on phase 10's typed graph, every node type's
    # features on the host: one step against the device-resident typed
    # trainer from the same weights, then timed steps
    tgraph, tpaths, make_encoder, anchors_t = (
        typed_ctx["graph"], typed_ctx["paths"], typed_ctx["make_encoder"],
        typed_ctx["anchors"])
    writes = EdgeType.from_str(WRITES)
    sup = dict(supervision_edge_type=writes,
               supervision_edges=tgraph.edges[writes],
               supervision_anchor="dst", device=dev)
    hdg = HeteroDeviceGraph.from_hetero(tgraph, tpaths, **sup)
    hdg_host = HeteroDeviceGraph.from_hetero(tgraph, tpaths,
                                             features_on_device=False, **sup)
    dpg = PartitionedHeteroGraph.build(hdg, tpaths, mesh,
                                       anchor_node_type="paper")
    hpg = PartitionedHeteroGraph.build(hdg_host, tpaths, mesh,
                                       anchor_node_type="paper",
                                       features_on_device=False)
    t_stores = {nt: ShardedHostStore.from_array(f, num_shards=shards)
                for nt, f in hdg_host.node_features.items()}
    tcfg = dict(anchor_node_type="paper", candidate_node_type="author",
                num_positives=1, num_hard_negs=0, num_random_negs=R,
                loss_type="retrieval", temperature=0.07)
    typed_paths = {"streamed_partitioned_typed_hgt_live": ("hgt", {}),
                   "streamed_partitioned_typed_hgt_tabularized": (
                       "hgt", {"tabularized": True}),
                   "streamed_partitioned_typed_rgcn_ring": (
                       "rgcn", {"global_candidate_pool": True})}
    for path, (conv, extra) in typed_paths.items():
        dpg_x, hpg_x = dpg, hpg
        if extra.get("tabularized"):
            dpg_x = dpg.with_sample_tables(hdg, tpaths, mesh, seed=0)
            hpg_x = hpg.with_sample_tables(hdg_host, tpaths, mesh, seed=0)
        tc = HeteroNALPTrainerConfig(**tcfg, **extra)
        dt = PartitionedHeteroNALPTrainer(
            HeteroLinkPredictionGNN(make_encoder(conv),
                                    LinkPredictionDecoder()),
            dpg_x, tpaths, tc, mesh, optimizer_args=opt,
            capacity_factor=PART_CAPACITY, overflow_policy="raise")
        ds = dt.init_state(0)
        params = {k: v.clone() for k, v in dt.model.state_dict().items()}
        tr = StreamingPartitionedHeteroNALPTrainer(
            HeteroLinkPredictionGNN(make_encoder(conv),
                                    LinkPredictionDecoder()),
            hpg_x, tpaths, tc, mesh, batch_size=BATCH, host_stores=t_stores,
            optimizer_args=opt, capacity_factor=PART_CAPACITY,
            overflow_policy="raise")
        st = tr.init_state(params=params)
        _, l_dev = dt.train_step(ds, anchors_t[0])
        st, l_st = tr.train_step(st, anchors_t[0])
        err = abs(float(l_st) - float(l_dev)) / abs(float(l_dev))
        check(err <= 1e-5, f"{path}: the streamed step's loss {float(l_st)}"
              f" differs from the device-resident one's {float(l_dev)}")
        del dt, ds
        kernels = ("route_requests", "unroute_rows") + (
            ("gather_rows",) if extra.get("tabularized")
            else ("sample_uniform",)) + (
            ("fanout_attention", "fanout_attention_bwd") if conv == "hgt"
            else ("masked_reduce", "masked_reduce_bwd")) + (
            ("ring_retrieval",) if extra.get("global_candidate_pool")
            else ("retrieval_loss",))
        st, row = timed(path, tr, st, anchors_t[1:], SP_TYPED_WARMUP,
                        SP_TYPED_STEPS, kernels, profiled=SP_TYPED_PROFILED)
        emit({"phase": "streamed_partitioned_typed_train_throughput",
              "model": conv, "card": card, "loss_rel_err_vs_device_resident":
                  err, **{k: v for k, v in row.items() if k != "losses"}})
        del tr, st
    del hdg, hdg_host, dpg, hpg, t_stores

    # -- (d) node classification: the labels routed inside the plan; one
    # step against the device-resident NC trainer, then timed steps
    nc_cfg = NodeClassificationTrainerConfig(fanouts=FANOUTS, cached_hop=True)
    dnc = PartitionedNodeClassificationTrainer(
        GNNEncoder(D, HID, C, num_layers=2, conv="graphsage"),
        PartitionedGraph.build(dg, mesh), mesh, nc_cfg, optimizer_args=opt,
        capacity_factor=PART_CAPACITY, overflow_policy="raise")
    ds = dnc.init_state(0)
    params = {k: v.clone() for k, v in dnc.model.state_dict().items()}
    tr = StreamingPartitionedNodeClassificationTrainer(
        GNNEncoder(D, HID, C, num_layers=2, conv="graphsage"), store, mesh,
        nc_cfg, batch_size=BATCH, optimizer_args=opt,
        capacity_factor=PART_CAPACITY, overflow_policy="raise",
        host_store=host)
    st = tr.init_state(params=params)
    _, l_dev = dnc.train_step(ds, anchors[0])
    st, l_st = tr.train_step(st, anchors[0])
    err = abs(float(l_st) - float(l_dev)) / abs(float(l_dev))
    check(err <= 1e-5, f"streamed NC loss {float(l_st)} differs from the "
          f"device-resident one's {float(l_dev)}")
    del dnc, ds
    path = "streamed_partitioned_nc"
    st, row = timed(path, tr, st, anchors[1:], SP_TYPED_WARMUP,
                    SP_TYPED_STEPS, ("route_requests", "unroute_rows",
                                     "gather_rows", "masked_reduce",
                                     "masked_reduce_bwd"),
                    profiled=SP_TYPED_PROFILED)
    acc = tr.evaluate([anchors[-1]])
    check(0.0 <= acc <= 1.0, f"{path}: accuracy {acc}")
    emit({"phase": "streamed_partitioned_nc_train_throughput", "card": card,
          "loss_rel_err_vs_device_resident": err, "accuracy": acc,
          "seeds_per_s": BATCH / (row["ms_per_step"] / 1e3),
          **{k: v for k, v in row.items() if k != "losses"}})
    del tr, st, host, store, mesh
    return counts


def _module_params(module, prefix):
    """``{prefix.name: parameter}`` of a module beside the encoder, whose
    gradients step_vs_plain holds too."""
    return {f"{prefix}.{n_}": p_ for n_, p_ in module.named_parameters()}


def _vs_checked(what, vs, fp32):
    """The tolerances of a step against its plain twin: fp32 1e-5 / 1e-4
    (sums in another order); bf16 1e-2 / 5e-2 (K4's and K5's sums rounded
    in another order, a bf16 ulp here and there). A gradient zero by
    symmetry is rounding noise on both sides, amplified where a loss
    divides by a batch's standard deviation (GBT, the whitening): held to
    1e-5 of the largest gradient (1e-3 of step_vs_plain's floor; GBT's
    last conv bias read 1.1e-6 of the largest on the H100)."""
    loss_tol, grad_tol = (1e-5, 1e-4) if fp32 else (1e-2, 5e-2)
    emit({"phase": f"{what}_vs_plain", "dtype": "float32" if fp32
          else "bfloat16", **vs})
    check(vs["loss_rel_err"] <= loss_tol,
          f"{what}: loss differs from the plain step: {vs}")
    zero = vs["symmetric_grad_rel_to_largest"]
    errs = vs["grad_err_rel_to_scale"]
    check(max((e for n, e in errs.items() if n not in zero), default=0.0)
          <= grad_tol, f"{what}: a gradient differs from the plain step: "
          f"{vs}")
    check(max((errs[n] for n in zero), default=0.0) <= 1e-3,
          f"{what}: a gradient zero by symmetry differs from the plain "
          f"step's by more than 1e-5 of the largest: {vs}")


def option_phases(dev, card, dg, run_path, opt_args, cfg, anchors):
    """Phase 22: the encoder and decoder options on the flagship NALP step
    and in inference (module docstring). Returns {path: (launch counts,
    steps)}."""
    from gigl_tpu_torch.inference.inferencer import (
        InferenceConfig, run_inference)
    from gigl_tpu_torch.models.encoders import GNNEncoder
    from gigl_tpu_torch.models.link_prediction import (
        LinkPredictionDecoder, LinkPredictionGNN)
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.training.trainer import NALPTrainer

    k1, k2 = FANOUTS
    edges_per_step = (2 * k1 + k1 * k2) * (BATCH + BATCH + R)
    out = {}
    a0 = torch.as_tensor(anchors[0], device=dev)
    live = dataclasses.replace(cfg, cached_hop=False, fused_cache=False)
    # path: (encoder options, decoder, config, steps, kernels, gradients
    # zero by symmetry: the MLP's last bias adds one constant to a query's
    # scores, which the retrieval softmax takes out; JK-lstm's att bias
    # adds one to every layer's score, which the softmax over layers takes
    # out: rounding noise only)
    variants = {
        "options_cached_train": (
            {"jk_mode": "cat", "linear_layer": True}, "hadamard_mlp", cfg,
            OPT_STEPS, OPT_KERNELS + ("build_neighbor_cache",),
            ("decoder.mlp1.bias",)),
        "options_live_train": (
            {"feature_interaction_layers": 2, "jk_mode": "lstm"}, "mlp",
            live, OPT_LIVE_STEPS, OPT_KERNELS,
            ("decoder.mlp1.bias", "jk.att.bias"))}
    for path, (opts, dec, cfg_, steps, kernels, zero) in variants.items():
        def make(dtype):
            return LinkPredictionGNN(
                GNNEncoder(D, HID, OUT, dtype=dtype, **opts),
                LinkPredictionDecoder(dec, hidden_dim=OPT_DECODER_HIDDEN,
                                      dtype=dtype, in_dim=OUT))

        # step 1 through the kernels and through the plain twins, fp32 (a
        # separate trainer: these launches are not the path's; the
        # symmetric gradients' noise nears 1e-3 of the largest in bf16, so
        # the check is made in fp32; the bf16 kernels' modes are held in
        # phases 3 and 5)
        chk = NALPTrainer(make(torch.float32), dg, cfg_,
                          optimizer_args=opt_args, device=dev)
        chk.init_state(0)
        batch0 = chk.sample_batch(a0, 0)
        vs = step_vs_plain(chk.model.encoder, lambda: chk.loss(batch0),
                           _build.launches, symmetric=zero,
                           extra=_module_params(chk.model.decoder, "decoder"))
        _vs_checked(path, vs, True)
        del chk, batch0
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr = NALPTrainer(make(torch.bfloat16), dg, cfg_,
                         optimizer_args=opt_args, device=dev)
        state = tr.init_state(0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        counts, n_, row = run_path(path, tr, state, steps, OPT_WARMUP,
                                   OPT_PROFILED, kernels, nodes=anchors,
                                   reset=False)
        out[path] = (counts, n_)
        emit({"phase": "options_train_throughput", "path": path,
              "encoder_options": opts, "decoder": dec,
              "decoder_hidden": OPT_DECODER_HIDDEN,
              "cached_hop": cfg_.cached_hop, "init_s": init_s,
              "edges_per_step": edges_per_step,
              "edges_per_s": edges_per_step / (row["ms_per_step"] / 1e3),
              **row})
        del tr, state

    # (c) a batch-norm encoder: train-mode passes on the module (fp32, each
    # against the plain twins, the running statistics too), a train step
    # refused, then run_inference in bf16 from the statistics it carries
    path = "options_bn_inference"
    tr32 = NALPTrainer(LinkPredictionGNN(
        GNNEncoder(D, HID, OUT, batchnorm=True, jk_mode="cat"),
        LinkPredictionDecoder()), dg, cfg, optimizer_args=opt_args,
        device=dev)
    state32 = tr32.init_state(0)
    enc32 = tr32.model.encoder
    w = torch.randn((BATCH, OUT), generator=torch.Generator(
        device=dev).manual_seed(22), device=dev)
    passes = []
    for p_ in range(BN_PASSES):
        ids = torch.as_tensor(anchors[p_], device=dev)
        start = {n_: b_.clone() for n_, b_ in enc32.named_buffers()}
        after = []

        def loss_fn():
            with torch.no_grad():
                for n_, b_ in enc32.named_buffers():
                    b_.copy_(start[n_])
            emb = tr32._encode_impl(tr32.graph, ids, 0, True)
            after.append({n_: b_.clone() for n_, b_ in
                          enc32.named_buffers()})
            return (emb.float() * w).sum() / BATCH

        # the convs' biases feed batch norm, whose batch mean takes them
        # out: no gradient
        vs = step_vs_plain(enc32, loss_fn, _build.launches, symmetric=(
            "convs.0.lin_self.bias", "convs.1.lin_self.bias"))
        stat_err = max(float((after[0][n_] - after[1][n_]).abs().max())
                       / float(after[1][n_].abs().max()) for n_ in start)
        moved = max(float((after[0][n_] - start[n_]).abs().max())
                    for n_ in start)
        with torch.no_grad():
            for n_, b_ in enc32.named_buffers():
                b_.copy_(after[0][n_])
        passes.append({"pass": p_, "stats_rel_err": stat_err,
                       "stats_moved": moved, **vs})
        _vs_checked(f"{path}_train_pass", vs, True)
        check(stat_err <= 1e-5, f"{path}: pass {p_}'s running statistics "
              f"differ from the plain pass's by {stat_err}")
        check(moved > 0, f"{path}: pass {p_} left the statistics as they "
              "were")
    try:
        tr32.train_step(state32, anchors[0])
        refused = False
    except ValueError as err:
        refused = "batch-norm encoder" in str(err)
    check(refused, f"{path}: a train step over batch norm was not refused")
    model16 = LinkPredictionGNN(
        GNNEncoder(D, HID, OUT, batchnorm=True, jk_mode="cat",
                   dtype=torch.bfloat16), LinkPredictionDecoder())
    model16.load_state_dict(tr32.model.state_dict())
    del tr32, state32
    _build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tr16 = NALPTrainer(model16, dg, cfg, device=dev)
    sink = Sink()
    with timed_window(path):
        total = run_inference(tr16, N, sink,
                              InferenceConfig(batch_size=BATCH), device=dev)
        torch.cuda.synchronize()
    inf_s = time.perf_counter() - t0
    counts = dict(_build.launches)
    emit({"phase": "main_path", "path": path, "launches": counts})
    for kname in INFERENCE_KERNELS:
        check(counts[kname] > 0, f"{kname} was not launched on the {path} "
              "path")
    check(total == N, f"{path}: {total} rows exported")
    embs = sink.table(N, OUT, path)
    ids0 = torch.arange(BATCH, dtype=torch.int32, device=dev)
    before = dict(_build.launches)
    with plain_kernels(), torch.inference_mode():
        ref0 = tr16._encode_impl(tr16.graph, ids0, 0, False).float().cpu()
    check(dict(_build.launches) == before, f"{path}: the plain batch "
          "launched a kernel")
    scale0 = float(ref0.abs().max())
    err0 = float(np.abs(embs[:BATCH] - ref0.numpy()).max())
    check(err0 <= 3e-2 * scale0, f"{path}: batch 0 differs from the plain "
          f"recomputation: {err0} vs {scale0}")
    n_batches = -(-N // BATCH)
    with torch.inference_mode(), timed_window(path), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for b_ in range(OPT_PROFILED):
            tr16._encode_impl(tr16.graph, ids0 + b_ * BATCH, 0, False)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t1) * 1e6
    ms_batch = inf_s / n_batches * 1e3
    emit({"phase": "options_bn_inference_throughput", "nodes": N,
          "batches": n_batches, "inference_s": inf_s,
          "ms_per_batch": ms_batch, "nodes_per_s": N / inf_s,
          "edges_per_batch": (2 * k1 + k1 * k2) * BATCH,
          "edges_per_s": (2 * k1 + k1 * k2) * N / inf_s,
          "batch0_max_abs_err": err0, "batch0_scale": scale0,
          "train_passes": passes, "train_step_refused": refused,
          "peak_mem_gb": (torch.cuda.max_memory_allocated() - base_mem)
          / 2**30,
          "profile": profile_summary(prof, OPT_PROFILED, window_us,
                                     ms_batch), "card": card})
    out[path] = (counts, n_batches)
    del tr16, model16, sink
    return out


def link_task_phase(dev, card, dg, arrays, run_path, opt_args):
    """Phase 23: LinkClassificationTrainer at the flagship (module
    docstring). Returns {path: (launch counts, steps)}."""
    from gigl_tpu_torch.models.encoders import GNNEncoder
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.training.link_task import (
        EdgeClassifierHead, LinkClassificationModel,
        LinkClassificationTrainer, LinkClassificationTrainerConfig)

    src, dst = arrays
    rng = np.random.default_rng(LINK_SEED)
    pick = rng.choice(E, LINK_EDGES, replace=False)
    edges = np.stack([src[pick], dst[pick]])
    labels = rng.integers(0, LINK_CLASSES, LINK_EDGES)
    n_batches = LINK_WARMUP + LINK_STEPS + OPT_PROFILED
    batches = (np.arange(BATCH * n_batches) % LINK_EDGES).reshape(
        n_batches, BATCH)
    lcfg = LinkClassificationTrainerConfig(fanouts=FANOUTS)

    def make(dtype):
        return LinkClassificationModel(
            GNNEncoder(D, HID, OUT, dtype=dtype),
            EdgeClassifierHead(OUT, LINK_CLASSES, hidden_dim=LINK_HIDDEN,
                               combine="hadamard", dtype=dtype))

    for dtype in (torch.float32, torch.bfloat16):
        chk = LinkClassificationTrainer(make(dtype), dg, edges, labels, lcfg,
                                        optimizer_args=opt_args, device=dev)
        chk.init_state(0)
        vs = step_vs_plain(chk.model.encoder, lambda: chk.loss(batches[0]),
                           _build.launches,
                           extra=_module_params(chk.model.head, "head"))
        _vs_checked("link_task_step", vs, dtype == torch.float32)
        del chk
    path = "link_task_train"
    tr = LinkClassificationTrainer(make(torch.bfloat16), dg, edges, labels,
                                   lcfg, optimizer_args=opt_args,
                                   device=dev)
    state = tr.init_state(0)
    counts, n_, row = run_path(path, tr, state, LINK_STEPS, LINK_WARMUP,
                               OPT_PROFILED, LINK_KERNELS, nodes=batches,
                               must_fall=False)
    k1, k2 = FANOUTS
    edges_per_step = (2 * k1 + k1 * k2) * 2 * BATCH
    eval_idx = np.arange(LINK_EVAL_BATCHES * BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timed_window(path):
        acc = tr.evaluate(eval_idx, batch_size=BATCH)
    eval_s = time.perf_counter() - t0
    check(0.0 <= acc <= 1.0, f"{path}: accuracy {acc}")
    t0 = time.perf_counter()
    with timed_window(path):
        logits = tr.predict_batch(edges[0, :BATCH], edges[1, :BATCH])
        torch.cuda.synchronize()
    predict_ms = (time.perf_counter() - t0) * 1e3
    check(logits.shape == (BATCH, LINK_CLASSES)
          and bool(torch.isfinite(logits.float()).all()),
          f"{path}: predict_batch is not finite [{BATCH}, {LINK_CLASSES}]")
    emit({"phase": "link_task_train_throughput", "labelled_edges":
          LINK_EDGES, "classes": LINK_CLASSES, "head_hidden": LINK_HIDDEN,
          "combine": "hadamard", "edges_per_step": edges_per_step,
          "edges_per_s": edges_per_step / (row["ms_per_step"] / 1e3),
          "eval_edges": int(eval_idx.size), "eval_accuracy": acc,
          "eval_ms_per_batch": eval_s / LINK_EVAL_BATCHES * 1e3,
          "predict_batch_ms": predict_ms, **row})
    del tr, state
    return {path: (counts, n_)}


class _SSLSteps:
    """An SSLTrainer's train_step with its generator bound, as run_path
    calls a trainer."""

    def __init__(self, trainer, generator):
        self.trainer, self.generator = trainer, generator

    def train_step(self, state, nodes):
        return self.trainer.train_step(state, nodes, self.generator)


def ssl_phases(dev, card, dg, run_path, opt_args, anchors):
    """Phase 24: SSLTrainer, each of the seven tasks in turn (module
    docstring). Returns {path: (launch counts, steps)}."""
    from gigl_tpu_torch.models.encoders import GNNEncoder
    from gigl_tpu_torch.models.ssl_tasks import ema_update
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.training.ssl_trainer import (
        SSL_TASKS, SSLTrainer, SSLTrainerConfig)

    k1, k2 = FANOUTS
    out = {}
    for task in SSL_TASKS:
        scfg = SSLTrainerConfig(task=task, fanouts=FANOUTS)
        # step 1 against the plain twins (fp32), the views drawn once
        chk = SSLTrainer(GNNEncoder(D, HID, OUT), dg, scfg,
                         optimizer_args=opt_args, device=dev)
        st = chk.init_state(0)
        gen = torch.Generator(device=dev).manual_seed(24)
        views = chk.draw_views(BATCH, gen)
        vs = step_vs_plain(chk.model.encoder, lambda: chk.loss(
            anchors[0], views, 0, st.target), _build.launches,
            symmetric=SSL_SYMMETRIC.get(task, ()),
            extra=_module_params(chk.model.head, "head"))
        _vs_checked(f"ssl_{task}_step", vs, True)
        ema = None
        if st.target is not None:
            # the target after a step: ema_update of the online encoder
            old = copy.deepcopy(st.target)
            st, _ = chk.train_step(st, anchors[0], views=views)
            ema_update(old, chk.encoder, scfg.ema_decay)
            ema = max(float((a_ - b_).abs().max()) for a_, b_ in zip(
                old.state_dict().values(), st.target.state_dict().values()))
            check(ema == 0.0, f"ssl {task}: the target is not ema_update of "
                  f"the online encoder ({ema})")
        del chk, st, views
        path = f"ssl_{task}_train"
        tr = SSLTrainer(GNNEncoder(D, HID, OUT, dtype=torch.bfloat16), dg,
                        scfg, optimizer_args=opt_args, device=dev)
        state = tr.init_state(0)
        steps = _SSLSteps(tr, torch.Generator(device=dev).manual_seed(1))
        kernels = SSL_KERNELS + (("uniform_ids",) if task == "directau"
                                 else ())
        counts, n_, row = run_path(path, steps, state, SSL_STEPS,
                                   SSL_WARMUP, OPT_PROFILED, kernels,
                                   nodes=anchors, must_fall=False)
        out[path] = (counts, n_)
        views_a_step = SSL_VIEWS[task]
        edges_per_step = (2 * k1 + k1 * k2) * views_a_step * BATCH
        emit({"phase": "ssl_train_throughput", "task": task,
              "views_encoded_per_step": views_a_step,
              "edges_per_step": edges_per_step,
              "edges_per_s": edges_per_step / (row["ms_per_step"] / 1e3),
              "target_ema_max_abs_err": ema, **row})
        del tr, state, steps
    return out


def main():
    if not (REPO / "gigl_tpu_torch" / "csrc").is_dir():
        sys.exit("chip_smoke: run from a checkout of the repository "
                 "(gigl_tpu_torch/ not found beside this script)")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    sys.path.insert(0, str(REPO))
    from gigl_tpu_torch.graph.csr import HeteroGraph
    from gigl_tpu_torch.inference.inferencer import (
        InferenceConfig, run_full_graph_inference, run_inference)
    from gigl_tpu_torch.models.convs import GATConv, SAGEConv, linear
    from gigl_tpu_torch.models.encoders import GNNEncoder
    from gigl_tpu_torch.models.init import init_params
    from gigl_tpu_torch.models.link_prediction import (
        LinkPredictionDecoder, LinkPredictionGNN)
    from gigl_tpu_torch.losses.losses import retrieval_masks
    from gigl_tpu_torch.ops import _build
    from gigl_tpu_torch.ops.attention import (
        _fanout_attention_bwd_plain, _fanout_attention_fwd,
        _fanout_attention_plain, fanout_attention_bwd)
    from gigl_tpu_torch.ops.ell import EllGraph
    from gigl_tpu_torch.ops.ell_aggregate import (
        _ell_aggregate_fwd, _ell_aggregate_graph_plain, _ell_aggregate_plain,
        _ell_transpose_plain, ell_aggregate_graph, ell_transpose_aggregate)
    from gigl_tpu_torch.ops.fanout import (
        MaskedReduce, _masked_reduce_bwd_plain, _masked_reduce_plain,
        masked_reduce, masked_reduce_bwd)
    from gigl_tpu_torch.ops.gather import (
        _expand_table_plain, _gather_rows_plain, expand_table, gather_rows)
    from gigl_tpu_torch.ops.hopcache import (
        _neighbor_cache_plain, build_neighbor_cache)
    from gigl_tpu_torch.ops.retrieval import (
        RetrievalLoss, _masked_logits_plain, _retrieval_bwd_plain,
        _retrieval_fwd_plain, retrieval_bwd, retrieval_fwd)
    from gigl_tpu_torch.sampling.neighbor_sampler import (
        _sample_uniform_plain, _uniform_ids_plain, sample_uniform,
        uniform_ids)
    from gigl_tpu_torch.training.dataset import DeviceGraph
    from gigl_tpu_torch.training.full_batch import (
        FullBatchTrainer, full_batch_data_from_graph)
    from gigl_tpu_torch.training.trainer import (
        NALPTrainer, NALPTrainerConfig, NodeClassificationTrainer,
        NodeClassificationTrainerConfig)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card = card.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # -- build ------------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds})
    count_host_index_builds()

    # -- the flagship graph, exactly as bench.py builds it -------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    graph = HeteroGraph.homogeneous(
        src=src, dst=dst, num_nodes=N,
        node_features=rng.normal(size=(N, D)).astype(np.float32),
        node_labels=rng.integers(0, C, N))
    dg = DeviceGraph.from_hetero(graph, supervision_edges=np.stack([src, dst]))
    torch.cuda.synchronize()
    emit({"phase": "graph", "seconds": time.perf_counter() - t0})
    csr, x, deg = dg.message_csr, dg.node_features, dg.degrees
    deg_i = torch.diff(csr.indptr.long())
    k1, k2 = FANOUTS
    results = []

    def record(name_, source, replaces, err, ms, plain_ms, nbytes, nops,
               library_ms=None, **extra):
        b, by = bound_ms(nbytes, nops)
        row = {"name": name_, "route": "cuda", "source": source,
               "replaces": replaces, "launches": None, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
               "library_ms": library_ms, **extra}
        results.append(row)
        emit({"phase": "kernel", **row})

    def unique(t):
        return int(torch.unique(t).numel())

    # -- K1 sample_uniform: the sample-table draw (fanout 15, hop 1) --------------
    ids_all = torch.arange(N, dtype=torch.int32, device=dev)

    def k1_kernel():
        return sample_uniform(csr.indptr, csr.indices, ids_all, k1, 0, 1)

    def k1_plain():
        return _sample_uniform_plain(csr.indptr, csr.indices, ids_all, k1, 0, 1)

    got = k1_kernel()
    for g, w in zip(got, k1_plain()):
        check(torch.equal(g, w), "K1 sample_uniform is not bit-equal")
    # bytes: indptr and frontier read once, the CSR slots drawn read once,
    # ids + mask + slots written; ops: ~24 integer ops per (node, slot).
    record("sample_uniform", "gigl_tpu_torch/csrc/sample_uniform.cu",
           "gigl_tpu/sampling/neighbor_sampler.py:176", 0.0,
           cuda_ms(k1_kernel), cuda_ms(k1_plain, reps=5),
           nbytes=(N + 1) * 4 + N * 4 + unique(got[2][got[1]]) * 4
           + N * k1 * 9,
           nops=N * k1 * 24, eager_ms=eager_ms(k1_kernel))
    table = torch.where(got[1], got[0], -1)

    # -- K2 build_neighbor_cache: mean of 10 rows into the fused table -----------
    fused = torch.empty((N, 2 * D), dtype=torch.float32, device=dev)
    fused[:, :D].copy_(x)

    def k2_kernel():
        return build_neighbor_cache(csr, x, fanout=k2, seed=0, hop_key=2,
                                    agg="mean", out=fused[:, D:])

    plain_cache = torch.empty((N, D), dtype=torch.float32, device=dev)

    def k2_plain():
        return _neighbor_cache_plain(csr, x, k2, 0, 2, "mean", None,
                                     plain_cache)

    k2_kernel()
    k2_plain()
    torch.testing.assert_close(fused[:, D:], plain_cache, rtol=1e-5, atol=1e-6)
    err2 = float((fused[:, D:] - plain_cache).abs().max())
    d_ids, d_mask, d_slots = _sample_uniform_plain(csr.indptr, csr.indices,
                                                   ids_all, k2, 0, 2)
    valid2 = int(d_mask.sum())
    k2_ms = cuda_ms(k2_kernel)
    # bytes: indptr, the drawn CSR slots and the drawn feature rows each read
    # once (a row drawn by several nodes counts once), the table written.
    # gathered_bytes: the rows the gather reads, one a valid slot.
    record("build_neighbor_cache", "gigl_tpu_torch/csrc/neighbor_cache.cu",
           "gigl_tpu/ops/hopcache.py:52", err2,
           k2_ms, cuda_ms(k2_plain, reps=5),
           nbytes=(N + 1) * 4 + unique(d_slots[d_mask]) * 4
           + unique(d_ids[d_mask]) * D * 4 + N * D * 4,
           nops=valid2 * D + N * D, gathered_bytes=valid2 * D * 4,
           gathered_tb_s=valid2 * D * 4 / (k2_ms * 1e9),
           eager_ms=eager_ms(k2_kernel))

    # -- K3 gather_rows: batch 0's expansion and fused-row hydration --------------
    roots = torch.arange(BATCH, dtype=torch.int32, device=dev)
    parent = torch.ones(BATCH, dtype=torch.bool, device=dev)
    nbr, m1 = expand_table(table, roots, parent)
    pn, pm = _expand_table_plain(table, roots, parent)
    check(torch.equal(nbr, pn) and torch.equal(m1, pm),
          "K3 expand mode is not bit-equal")
    level_ids = torch.cat([roots, nbr.reshape(-1)])

    def k3_kernel():
        return gather_rows(fused, level_ids, deg)

    rows, degs = k3_kernel()
    prow, pdeg = _gather_rows_plain(fused, level_ids, deg)
    check(torch.equal(rows, prow) and torch.equal(degs, pdeg),
          "K3 rows mode is not bit-equal")
    idx64 = level_ids.long()
    mrows, urows = level_ids.shape[0], unique(level_ids)
    # bytes: ids read, each distinct fused row (1 KB) and degree read once,
    # every gathered row and degree written.
    record("gather_rows", "gigl_tpu_torch/csrc/gather_rows.cu",
           "gigl_tpu/training/dataset.py:419", 0.0,
           cuda_ms(k3_kernel),
           cuda_ms(lambda: _gather_rows_plain(fused, level_ids, deg)),
           nbytes=mrows * 4 + (urows + mrows) * (2 * D * 4 + 4), nops=0,
           library_ms=cuda_ms(lambda: torch.index_select(fused, 0, idx64)),
           eager_ms=eager_ms(k3_kernel),
           expand_ms=cuda_ms(lambda: expand_table(table, roots, parent)),
           expand_plain_ms=cuda_ms(
               lambda: _expand_table_plain(table, roots, parent)),
           expand_bound_ms=bound_ms(BATCH * 5 + 2 * BATCH * k1 * 4
                                    + BATCH * k1, 0)[0])

    # -- K4 masked_reduce: layer 2's mean over [512, 15, 256] bf16 -----------------
    h1 = torch.randn((BATCH, k1, HID), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev).to(torch.bfloat16)

    def k4_kernel():
        return masked_reduce(h1, m1, "mean")

    got4 = k4_kernel()
    want4 = _masked_reduce_plain(h1, m1, "mean")
    scale = float(want4.float().abs().max())
    err4 = float((got4.float() - want4.float()).abs().max())
    check(err4 <= 2e-2 * scale, f"K4 masked_reduce error {err4} > 2e-2*{scale}")
    valid4 = int(m1.sum())
    # bytes: the valid slot rows and the mask read once, [M, D] written.
    record("masked_reduce", "gigl_tpu_torch/csrc/masked_reduce.cu",
           "gigl_tpu/ops/fanout.py:34", err4,
           cuda_ms(k4_kernel),
           cuda_ms(lambda: _masked_reduce_plain(h1, m1, "mean")),
           nbytes=valid4 * HID * 2 + BATCH * k1 + BATCH * HID * 2,
           nops=valid4 * HID + BATCH * HID, eager_ms=eager_ms(k4_kernel))

    # -- the main path: refresh the tables, then embed every node -----------------
    torch.manual_seed(0)
    model = LinkPredictionGNN(
        GNNEncoder(D, HID, OUT, num_layers=2, conv="graphsage",
                   dtype=torch.bfloat16), LinkPredictionDecoder())
    cfg = NALPTrainerConfig(fanouts=FANOUTS, num_random_negs=R,
                            loss_type="retrieval", num_positives=1,
                            cached_hop=True, fused_cache=True)
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = NALPTrainer(model, dg, cfg)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    trainer.init_params(0)
    sink = Sink()
    t0 = time.perf_counter()
    total = run_inference(trainer, N, sink, InferenceConfig(batch_size=BATCH))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches_inf = dict(_build.launches)
    n_batches = -(-N // BATCH)
    emit({"phase": "main_path", "path": "inference", "launches": launches_inf,
          "refresh_s": refresh_s, "inference_s": cold_s})
    for kname in INFERENCE_KERNELS:
        check(launches_inf[kname] > 0,
              f"{kname} was not launched on the inference path")

    ids = np.concatenate(sink.ids)
    embs = np.concatenate(sink.embs)
    check(total == N and ids.shape == (N,), "wrong number of exported rows")
    check(np.array_equal(np.sort(ids), np.arange(N)),
          "exported ids are not every node exactly once")
    check(embs.shape == (N, OUT) and np.isfinite(embs).all(),
          "embeddings are not finite [N, 128]")

    # warm pass (timing only; the launch counts above are the main path's)
    sink2 = Sink()
    t0 = time.perf_counter()
    run_inference(trainer, N, sink2, InferenceConfig(batch_size=BATCH))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(np.array_equal(np.concatenate(sink2.embs), embs),
          "a second inference pass differs from the first")
    ids_t = torch.arange(BATCH, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        device_ms = cuda_ms(
            lambda: trainer._encode_impl(trainer.graph, ids_t, 0, False),
            reps=10)
    emit({"phase": "throughput", "nodes": N, "batches": n_batches,
          "device_ms_per_batch": device_ms,
          "cold_nodes_per_s": N / cold_s, "warm_nodes_per_s": N / warm_s,
          "cold_ms_per_batch": cold_s / n_batches * 1e3,
          "warm_ms_per_batch": warm_s / n_batches * 1e3,
          "refresh_ms": refresh_s * 1e3, "card": card})

    # -- batch 0 again, through the plain versions only -------------------------
    with torch.inference_mode():
        enc = trainer.model.encoder
        ids0, m0, _ = _sample_uniform_plain(csr.indptr, csr.indices, roots,
                                            k1, cfg.seed, 1)
        nbr0 = torch.where(m0, ids0, 0)
        h = []
        for lvl in (roots, nbr0.reshape(-1)):
            cn, cm, _ = _sample_uniform_plain(csr.indptr, csr.indices, lvl,
                                              k2, cfg.seed, len(FANOUTS))
            agg = _masked_reduce_plain(x[cn.long()], cm, "mean")
            xin = x[lvl.long()].to(torch.bfloat16)
            h.append(torch.relu(enc.convs[0].block_cached(xin, agg)))
        agg2 = _masked_reduce_plain(h[1].reshape(BATCH, k1, HID), m0, "mean")
        ref0 = enc.convs[1]._combine(h[0], agg2).float().cpu().numpy()
    got0 = embs[:BATCH]
    scale0 = float(np.abs(ref0).max())
    err0 = float(np.abs(got0 - ref0).max())
    emit({"phase": "batch0_vs_plain", "max_abs_err": err0, "scale": scale0})
    check(err0 <= 3e-2 * scale0,
          f"batch 0 differs from the plain recomputation: {err0} vs {scale0}")

    # -- training: the new kernels on a real first step ------------------------
    # A separate trainer with the same seeds as the main path's: launches
    # made here to compare kernels with their plain versions are not counted.
    def make_model():
        return LinkPredictionGNN(
            GNNEncoder(D, HID, OUT, num_layers=2, conv="graphsage",
                       dtype=torch.bfloat16), LinkPredictionDecoder())

    opt_args = {"learning_rate": "1e-3"}
    anchors = (np.arange(BATCH * STEPS) % N).astype(np.int32).reshape(
        STEPS, BATCH)
    chk = NALPTrainer(make_model(), dg, cfg, optimizer_args=opt_args)
    chk.init_state(0, batch_size=BATCH)
    a0 = torch.as_tensor(anchors[0], device=dev)
    batch0 = chk.sample_batch(a0, 0)
    sup = dg.supervision_csr
    pos_p, pmask_p, _ = _sample_uniform_plain(sup.indptr, sup.indices, a0, 1,
                                              cfg.seed, 1_000_003)
    rand_p = _uniform_ids_plain(R, cfg.seed, 3_000_017, N, dev)
    check(torch.equal(batch0.pos, pos_p)
          and torch.equal(batch0.pos_mask, pmask_p),
          "K1 positives of step 0 are not bit-equal")
    check(torch.equal(batch0.random_neg, rand_p),
          "K1b random negatives of step 0 are not bit-equal")

    def k1b_kernel(count=R):
        return uniform_ids(count, cfg.seed, 3_000_017, N, dev)

    # K1b behind K1's draw of the positives, as the step runs them (K1b a
    # dependent launch that hashes while K1 runs): the pair replayed from
    # one CUDA graph, beside K1 alone, both outputs held to the twins. The
    # pair's time is K1b's yardstick: its own duration includes its wait.
    def k1_positives():
        return sample_uniform(sup.indptr, sup.indices, a0, 1, cfg.seed,
                              1_000_003)

    def k1_k1b_pair():
        return k1_positives() + (k1b_kernel(),)

    got_pair = k1_k1b_pair()
    check(all(torch.equal(g_, w_) for g_, w_ in zip(
        got_pair, (pos_p, pmask_p,
                   _sample_uniform_plain(sup.indptr, sup.indices, a0, 1,
                                         cfg.seed, 1_000_003)[2], rand_p))),
          "the K1 -> K1b pair is not bit-equal to the twins")
    wide = 65_536
    check(torch.equal(k1b_kernel(wide), _uniform_ids_plain(
        wide, cfg.seed, 3_000_017, N, dev)),
          f"K1b at {wide} ids is not bit-equal")
    # bytes: R int32 ids written; ops: ~24 integer ops per id.
    record("uniform_ids", "gigl_tpu_torch/csrc/sample_uniform.cu",
           "gigl_tpu/training/dataset.py:291", 0.0, cuda_ms(k1b_kernel),
           cuda_ms(lambda: _uniform_ids_plain(R, cfg.seed, 3_000_017, N,
                                              dev)),
           nbytes=R * 4, nops=R * 24, eager_ms=eager_ms(k1b_kernel),
           library_ms=cuda_ms(lambda: torch.randint(
               0, N, (R,), device=dev, dtype=torch.int32)),
           library_call="torch.randint(0, N, (R,)): the same distribution, "
                        "other bits",
           ms_of="K1b after K1b: launches replayed from one CUDA graph, "
                 "each starting while the one before finishes, which no "
                 "path does; the yardstick is the K1 -> K1b pair, "
                 "modes['pair_512']['pair_ms']",
           modes={
               "pair_512": {
                   "bit_equal": True, "anchors": BATCH, "positives": 1,
                   "pair_ms": cuda_ms(k1_k1b_pair),
                   "k1_alone_ms": cuda_ms(k1_positives),
                   "eager_pair_ms": eager_ms(k1_k1b_pair)},
               f"wide_{wide}": {
                   "bit_equal": True, "ids": wide,
                   "ms": cuda_ms(lambda: k1b_kernel(wide)),
                   "plain_ms": cuda_ms(lambda: _uniform_ids_plain(
                       wide, cfg.seed, 3_000_017, N, dev)),
                   "bound_ms": bound_ms(wide * 4, wide * 24)[0],
                   "library_ms": cuda_ms(lambda: torch.randint(
                       0, N, (wide,), device=dev, dtype=torch.int32)),
                   "eager_ms": eager_ms(lambda: k1b_kernel(wide))}})

    # K5 on the step's real [512, 1024] bf16 score matrix
    with torch.no_grad():
        q0, pos0, _, rand0 = chk._scores(chk.graph, batch0, train=True)
        scores = chk.model.decode_all_pairs(
            q0, torch.cat([pos0.reshape(BATCH, OUT), rand0]))
    cids = torch.cat([batch0.pos.reshape(-1), batch0.random_neg])
    masks = retrieval_masks(
        temperature=cfg.temperature, query_ids=batch0.anchors,
        candidate_ids=cids, remove_accidental_hits=True,
        query_mask=batch0.pos_mask.reshape(-1),
        candidate_mask=torch.cat([batch0.pos_mask.reshape(-1),
                                  torch.ones(R, dtype=torch.bool,
                                             device=dev)]))
    check(scores.shape == (BATCH, BATCH + R)
          and scores.dtype == torch.bfloat16, "step-0 scores are not "
          "[512, 1024] bf16")
    hit_cells = int((cids[:BATCH, None] == cids[None, :]).sum()) - BATCH
    loss_k, cnt_k, lse_k, _ = retrieval_fwd(scores, masks)
    loss_p, cnt_p, lse_p, _ = _retrieval_fwd_plain(scores, masks)
    g5 = 1.0 / torch.clamp(cnt_k.float(), min=1.0)   # d mean / d loss_sum
    ds_k = retrieval_bwd(scores, masks, lse_k, g5)
    ds_p = _retrieval_bwd_plain(scores, masks, lse_p, g5)
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    check(int(cnt_k) == int(cnt_p), "K5 count differs from its plain version")
    check(loss_rel <= 1e-5, f"K5 loss_sum relative error {loss_rel} > 1e-5")
    check(torch.equal(retrieval_fwd(scores, masks)[0], loss_k),
          "K5 forward is not bit-equal on a repeat run")
    ds_scale = float(ds_p.float().abs().max())
    ds_ulp = 2.0 ** (np.floor(np.log2(ds_scale)) - 7)
    err5 = float((ds_k.float() - ds_p.float()).abs().max())
    check(err5 <= ds_ulp, f"K5 dS error {err5} > one bf16 ulp {ds_ulp}")
    v_lib = _masked_logits_plain(scores, masks).to(torch.bfloat16)
    v_lib.requires_grad_()
    target = torch.where(masks.query_mask,
                         torch.arange(BATCH, device=dev), -100)

    def k5_library():
        return torch.autograd.grad(
            F.cross_entropy(v_lib, target, ignore_index=-100,
                            reduction="sum"), v_lib)

    k5_device_launches = {
        "fwd": device_launches(lambda: retrieval_fwd(scores, masks),
                               "retrieval_"),
        "bwd": device_launches(
            lambda: retrieval_bwd(scores, masks, lse_k, g5), "retrieval_")}
    check(k5_device_launches == {"fwd": 1, "bwd": 1},
          f"K5 made {k5_device_launches} CUDA launches, not 1 and 1")
    fwd_ms = cuda_ms(lambda: retrieval_fwd(scores, masks))
    bwd_ms = cuda_ms(lambda: retrieval_bwd(scores, masks, lse_k, g5))
    plain_fwd_ms = cuda_ms(lambda: _retrieval_fwd_plain(scores, masks))
    plain_bwd_ms = cuda_ms(
        lambda: _retrieval_bwd_plain(scores, masks, lse_p, g5))
    qc = BATCH * (BATCH + R)
    ids_bytes = BATCH * 4 + (BATCH + R) * 4 + BATCH + (BATCH + R)
    # bytes: forward reads S, ids and masks once and writes lse, ce and
    # the two scalars; backward reads S, ids, masks, lse and g once and
    # writes dS. ops: ~6 fp32 ops per cell forward, ~7 backward.
    record("retrieval_loss", "gigl_tpu_torch/csrc/retrieval_loss.cu",
           "gigl_tpu/losses/losses.py:95", err5, fwd_ms + bwd_ms,
           plain_fwd_ms + plain_bwd_ms,
           nbytes=(qc * 2 + ids_bytes + BATCH * 8 + 8)
           + (qc * 4 + ids_bytes + BATCH * 4 + 4),
           nops=qc * 13, library_ms=cuda_ms(k5_library),
           fwd_ms=fwd_ms, bwd_ms=bwd_ms, plain_fwd_ms=plain_fwd_ms,
           plain_bwd_ms=plain_bwd_ms, cuda_launches=k5_device_launches,
           loss_rel_err=loss_rel,
           ds_scale=ds_scale, accidental_hit_cells=hit_cells,
           eager_ms=eager_ms(lambda: retrieval_bwd(
               scores, masks, *retrieval_fwd(scores, masks)[2:3], g5)))

    # K4b on layer 2's [512, 15, 256] bf16 block: mean, and max with ties
    g4 = torch.randn((BATCH, HID), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev).to(torch.bfloat16)

    def k4b_kernel():
        return masked_reduce_bwd(g4, m1, "mean")

    def within_ulp(got, want, what):
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        check(err <= ulp, f"{what} error {err} > one bf16 ulp {ulp}")
        return err

    err4b = within_ulp(k4b_kernel(), _masked_reduce_bwd_plain(g4, m1, "mean"),
                       "K4b mean")
    x_ties = (h1.float() * 2).round().to(torch.bfloat16)
    out_ties = masked_reduce(x_ties, m1, "max")
    n_ties = int(((x_ties == out_ties[:, None, :]) & m1[..., None]).sum(1)
                 .max())
    check(n_ties > 1, "the K4b max input has no ties")
    err4b = max(err4b, within_ulp(
        masked_reduce_bwd(g4, m1, "max", x_ties, out_ties),
        _masked_reduce_bwd_plain(g4, m1, "max", x_ties, out_ties),
        "K4b max (ties)"))
    # The sum mode beside torch.where, the one PyTorch call that computes
    # it (the same bits).
    def k4b_sum():
        return masked_reduce_bwd(g4, m1, "sum")

    def k4b_library():
        return torch.where(m1[..., None], g4[:, None, :], 0)

    check(torch.equal(k4b_sum(), k4b_library()),
          "K4b sum differs from torch.where")
    # bytes: grad_out and the mask read once, [M, K, D] written; ops: one
    # divide per output value (mean).
    record("masked_reduce_bwd", "gigl_tpu_torch/csrc/masked_reduce.cu",
           "gigl_tpu/ops/fanout.py:34", err4b, cuda_ms(k4b_kernel),
           cuda_ms(lambda: _masked_reduce_bwd_plain(g4, m1, "mean")),
           nbytes=BATCH * HID * 2 + BATCH * k1 + BATCH * k1 * HID * 2,
           nops=BATCH * HID, library_ms=cuda_ms(k4b_library),
           library_call="torch.where(mask[..., None], g[:, None, :], 0), "
           "beside sum_ms", sum_ms=cuda_ms(k4b_sum), max_ties=n_ties,
           eager_ms=eager_ms(k4b_kernel))

    # -- one training step again, through the plain versions only ------------
    chk.model.zero_grad(set_to_none=True)
    loss_kp = chk.loss(batch0)
    loss_kp.backward()
    grads_k = {n: p.grad.detach().clone()
               for n, p in chk.model.named_parameters()}
    chk.model.zero_grad(set_to_none=True)
    enc_t, fused_t = chk.model.encoder, chk.graph.fused_table
    table_t = chk.graph.sample_tables[k1]

    def encode_plain(ids):
        roots_ = ids.reshape(-1).to(torch.int32)
        nbr_, m_ = _expand_table_plain(table_t, roots_,
                                       torch.ones_like(roots_, dtype=torch.bool))
        h_ = []
        for lvl in (roots_, nbr_.reshape(-1)):
            rows_, _ = _gather_rows_plain(fused_t, lvl)
            h_.append(torch.relu(enc_t.convs[0].block_cached(
                rows_[:, :D].to(torch.bfloat16), rows_[:, D:])))
        agg_ = MaskedReduce.apply(h_[1].reshape(-1, k1, HID), m_, "mean",
                                  _masked_reduce_plain,
                                  _masked_reduce_bwd_plain)
        return enc_t.convs[1]._combine(h_[0], agg_)

    scores_p = chk.model.decode_all_pairs(
        encode_plain(a0), torch.cat([encode_plain(pos_p),
                                     encode_plain(rand_p)]))
    lsum_p, lcnt_p = RetrievalLoss.apply(scores_p, masks,
                                         _retrieval_fwd_plain,
                                         _retrieval_bwd_plain)
    loss_pp = lsum_p / torch.clamp(lcnt_p.float(), min=1.0)
    loss_pp.backward()
    step_rel = abs(float(loss_kp) - float(loss_pp)) / abs(float(loss_pp))
    grad_errs = {}
    for n, p in chk.model.named_parameters():
        scale = float(p.grad.abs().max())
        check(scale > 0, f"plain step: no gradient for {n}")
        grad_errs[n] = float((grads_k[n] - p.grad).abs().max()) / scale
    emit({"phase": "train_step_vs_plain", "loss": float(loss_kp),
          "loss_plain": float(loss_pp), "loss_rel_err": step_rel,
          "grad_err_rel_to_scale": grad_errs})
    # bf16 compute: the two paths round K4's and K5's fp32 sums in another
    # order, so values may differ by a bf16 ulp (2**-7 relative) here and
    # there; the loss within 1e-2 relative, every gradient within 5e-2 of
    # its largest entry.
    check(step_rel <= 1e-2, f"plain step loss differs by {step_rel}")
    for n, e in grad_errs.items():
        check(e <= 5e-2, f"plain step gradient of {n} differs by {e}")
    del chk, scores, scores_p, v_lib

    # -- the training main path --------------------------------------------------
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer_t = NALPTrainer(make_model(), dg, cfg, optimizer_args=opt_args)
    state = trainer_t.init_state(0, batch_size=BATCH)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    after_init = dict(_build.launches)
    gen = torch.Generator(device=dev).manual_seed(1)
    state, warm_losses = trainer_t.train_steps(state, anchors[:WARMUP], gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, losses = trainer_t.train_steps(state, anchors, gen)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(_build.launches)
    emit({"phase": "main_path", "path": "training", "launches": launches,
          "launches_at_init": after_init, "init_s": init_s,
          "steps": WARMUP + STEPS})
    for kname in TRAINING_KERNELS:
        check(launches[kname] > 0,
              f"{kname} was not launched on the training path")
    losses = losses.float().cpu().numpy()
    check(np.isfinite(losses).all() and np.isfinite(
        warm_losses.float().cpu().numpy()).all(), "training loss not finite")
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    check(last < first, f"training loss did not decrease: {first} -> {last}")
    ms_step = train_s / STEPS * 1e3
    edges_per_step = (2 * k1 + k1 * k2) * (BATCH + BATCH + R)
    emit({"phase": "train_throughput", "steps": STEPS, "ms_per_step": ms_step,
          "edges_per_step": edges_per_step,
          "edges_per_s": edges_per_step / (ms_step / 1e3),
          "loss_first20": first, "loss_last20": last,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
          "card": card})

    # -- where the step's device time goes (torch.profiler) -------------------
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = trainer_t.train_steps(state, anchors[:PROFILED], gen)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    emit({"phase": "train_profile", "steps": PROFILED,
          **profile_summary(prof, PROFILED, window_us, ms_step)})

    # -- exact full-graph inference through the ELL buckets ---------------------
    et = graph.metadata.edge_types[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ell = EllGraph.from_csr(graph.csr(et, anchor="dst"), device=dev)
    torch.cuda.synchronize()
    ell_build_s = time.perf_counter() - t0
    sizes = [hi - lo for lo, hi in zip(ell.boundaries, ell.boundaries[1:])]
    emit({"phase": "ell_graph", "build_s": ell_build_s,
          "widths": list(ell.widths), "rows_per_bucket": sizes,
          "padded_entries": sum(n_ * w_ for n_, w_ in zip(sizes, ell.widths)),
          "edges": int(sum(int(m_.sum()) for m_ in ell.mask))})
    big = int(np.argmax(sizes))
    lo_b, hi_b = ell.boundaries[big], ell.boundaries[big + 1]
    nbr_b, mask_b = ell.nbr[big], ell.mask[big]
    n_b, w_b = nbr_b.shape
    valid_b = int(mask_b.sum())
    uniq_b = unique(nbr_b[mask_b])
    deg_dst_b = ell.deg_p[lo_b:hi_b].contiguous()
    gen6 = torch.Generator(device=dev).manual_seed(6)
    x6 = torch.randn((N, HID), generator=gen6, device=dev).to(torch.bfloat16)

    def rel_err(got, want, what, tol=2e-2):
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        check(err <= tol * scale, f"{what} error {err} > {tol}*{scale}")
        return err

    # K6 in every mode at the largest bucket: its rows (lo_b, hi_b) of the
    # one launch over the graph. bytes: each distinct valid neighbor row
    # read once, each valid slot's id and each row's count read once,
    # [n_b, D] written (GCN: the degrees of those rows too); ops: one
    # multiply-add per valid slot and value.
    k6 = {}
    for op in ("mean", "sum", "max", "gcn"):
        def k6_kernel(op=op):
            return _ell_aggregate_fwd(x6, ell, op, rows=(lo_b, hi_b))

        def k6_plain(op=op):
            return _ell_aggregate_graph_plain(x6, ell, op, rows=(lo_b, hi_b))

        err = rel_err(k6_kernel(), k6_plain(), f"K6 {op}")
        k6[op] = {"err": err, "ms": cuda_ms(k6_kernel),
                  "plain_ms": cuda_ms(k6_plain, reps=3),
                  "eager_ms": eager_ms(k6_kernel)}
    crow = torch.zeros(n_b + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(mask_b.sum(1), 0)
    adj = torch.sparse_csr_tensor(
        crow, nbr_b[mask_b].long(),
        torch.ones(valid_b, dtype=torch.bfloat16, device=dev), (n_b, N))
    k6_bytes = uniq_b * HID * 2 + valid_b * 4 + n_b * 4 + n_b * HID * 2
    # K6 over a whole layer, one launch over every bucket, at the widths
    # the paths run: the full-graph pass's two layers (bf16 [N, 128] and
    # [N, 256]) and the ELL full-batch step's (fp32), mean. bytes: each
    # distinct source row once, every valid slot's id (GINE: and its edge
    # id and edge row), every row's count, [N, D] written; the bound of a
    # path's K6 is the sum over its two layers.
    n_edges = int(ell.ent_mask.sum())
    src_rows = unique(ell.ent_src[ell.ent_mask])

    def k6_layer_bound(d_, elt, edge_elt=0):
        nbytes = (src_rows * d_ * elt + n_edges * 4 + N * 4 + N * d_ * elt
                  + (n_edges * (4 + d_ * edge_elt) if edge_elt else 0))
        return bound_ms(nbytes, n_edges * d_ * (3 if edge_elt else 1))[0]

    k6_layers = {}
    for label, d_, dt_ in (("bf16_d128", D, torch.bfloat16),
                           ("bf16_d256", HID, torch.bfloat16),
                           ("fp32_d128", D, torch.float32),
                           ("fp32_d256", HID, torch.float32)):
        xl = torch.randn((N, d_), generator=gen6, device=dev).to(dt_)

        def k6l_kernel(xl=xl):
            return _ell_aggregate_fwd(xl, ell, "mean")

        def k6l_plain(xl=xl):
            return _ell_aggregate_graph_plain(xl, ell, "mean")

        err = rel_err(k6l_kernel(), k6l_plain(), f"K6 mean layer {label}")
        k6_layers[label] = {
            "err": err, "ms": cuda_ms(k6l_kernel),
            "plain_ms": cuda_ms(k6l_plain, reps=1),
            "bound_ms": k6_layer_bound(d_, xl.element_size())}
        del xl
    k6_path_bounds = {
        "full_graph_graphsage": k6_layers["bf16_d128"]["bound_ms"]
        + k6_layers["bf16_d256"]["bound_ms"],
        "full_batch_graphsage": k6_layers["fp32_d128"]["bound_ms"]
        + k6_layers["fp32_d256"]["bound_ms"],
        "edge_full_graph_gine": 2 * k6_layer_bound(EDGE_GINE_HID, 2, 2),
        "edge_full_batch_gine": 2 * k6_layer_bound(EDGE_GINE_HID, 4, 4)}
    record("ell_aggregate", "gigl_tpu_torch/csrc/ell_aggregate.cu",
           "gigl_tpu/ops/ell.py:237", max(v["err"] for v in k6.values()),
           k6["mean"]["ms"], k6["mean"]["plain_ms"],
           nbytes=k6_bytes, nops=valid_b * HID,
           library_ms=cuda_ms(lambda: torch.sparse.mm(adj, x6)),
           library_call="torch.sparse.mm (CSR bucket adjacency, bf16) = sum",
           bucket=[n_b, w_b], valid_slots=valid_b, distinct_rows=uniq_b,
           eager_ms=k6["mean"]["eager_ms"],
           modes={op: {**v, "bound_ms": bound_ms(
               k6_bytes + (uniq_b * 4 + n_b * 4 if op == "gcn" else 0),
               valid_b * HID * (2 if op == "gcn" else 1))[0]}
               for op, v in k6.items()},
           layers=k6_layers, path_bounds_ms=k6_path_bounds)

    # K7 in every mode at GAT layer 1's widths (H=4, Dh=64). bytes: xd, each
    # distinct valid source row of ks (and of vs when it is another table)
    # read once, nbr and mask, [n_b, H*Dh] written; ops per valid slot and
    # value: logits 2 (GATv2 4) and the weighted sum 2.
    hd7, dh7 = HID, HID // GAT_HEADS
    xd7, ks7, vs7 = (torch.randn(s_, generator=gen6, device=dev).to(
        torch.bfloat16) for s_ in ((n_b, hd7), (N, hd7), (N, hd7)))
    att7, att7b = (torch.randn((GAT_HEADS, dh7), generator=gen6, device=dev)
                   * 0.2 for _ in range(2))
    k7 = {}
    for mode, vs_, atts in (("gat", ks7, (att7, att7b)),
                            ("gatv2", ks7, (att7, None)),
                            ("transformer", vs7, (None, None))):
        flat = [None if a is None else a.reshape(-1) for a in atts]

        def k7_kernel(mode=mode, vs_=vs_, flat=flat):
            return _fanout_attention_fwd(xd7, ks7, vs_, nbr_b, mask_b, mode,
                                         GAT_HEADS, *flat, 0.2)

        def k7_plain(mode=mode, vs_=vs_, flat=flat):
            return _fanout_attention_plain(xd7, ks7, vs_, nbr_b, mask_b,
                                           mode, GAT_HEADS, *flat)

        err = rel_err(k7_kernel(), k7_plain(), f"K7 {mode}")
        tables = 2 if mode == "transformer" else 1
        nbytes = (n_b * hd7 * 2 + uniq_b * hd7 * 2 * tables + n_b * w_b * 5
                  + n_b * hd7 * 2)
        nops = valid_b * hd7 * (6 if mode == "gatv2" else 4)
        k7[mode] = {"err": err, "ms": cuda_ms(k7_kernel),
                    "plain_ms": cuda_ms(k7_plain, reps=3),
                    "eager_ms": eager_ms(k7_kernel),
                    "bound_ms": bound_ms(nbytes, nops)[0],
                    "nbytes": nbytes, "nops": nops}
    # GAT in fp32 at the full-batch GAT step's two layers: Dh 64 (hidden
    # 256) and Dh 4 (16 classes over 4 heads), the same bucket
    for hd_ in (HID, C):
        xd_, ks_ = (torch.randn(s_, generator=gen6, device=dev)
                    for s_ in ((n_b, hd_), (N, hd_)))
        a1_, a2_ = (torch.randn(hd_, generator=gen6, device=dev) * 0.2
                    for _ in range(2))

        def k7f_kernel(xd_=xd_, ks_=ks_, a1_=a1_, a2_=a2_):
            return _fanout_attention_fwd(xd_, ks_, ks_, nbr_b, mask_b, "gat",
                                         GAT_HEADS, a1_, a2_, 0.2)

        def k7f_plain(xd_=xd_, ks_=ks_, a1_=a1_, a2_=a2_):
            return _fanout_attention_plain(xd_, ks_, ks_, nbr_b, mask_b,
                                           "gat", GAT_HEADS, a1_, a2_)

        # fp32 sums and exps in another order
        err = rel_err(k7f_kernel(), k7f_plain(),
                      f"K7 gat fp32 Dh {hd_ // GAT_HEADS}", tol=1e-5)
        nbytes = n_b * hd_ * 4 * 2 + uniq_b * hd_ * 4 + n_b * w_b * 5
        nops = valid_b * hd_ * 4
        k7[f"gat_dh{hd_ // GAT_HEADS}_fp32"] = {
            "err": err, "ms": cuda_ms(k7f_kernel),
            "plain_ms": cuda_ms(k7f_plain, reps=3),
            "eager_ms": eager_ms(k7f_kernel),
            "bound_ms": bound_ms(nbytes, nops)[0], "nbytes": nbytes,
            "nops": nops, "head_dim": hd_ // GAT_HEADS}
        del xd_, ks_
    q_s = xd7.reshape(n_b, GAT_HEADS, 1, dh7)
    k_s, v_s = (t_[nbr_b.long()].reshape(n_b, w_b, GAT_HEADS, dh7)
                .transpose(1, 2).contiguous() for t_ in (ks7, vs7))
    sdpa_mask = mask_b[:, None, None, :]

    def sdpa():
        # cuDNN's SDPA refuses this boolean mask on the card; the
        # memory-efficient backend takes it.
        with torch.nn.attention.sdpa_kernel(
                [torch.nn.attention.SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q_s, k_s, v_s,
                                                  attn_mask=sdpa_mask)

    record("fanout_attention", "gigl_tpu_torch/csrc/fanout_attention.cu",
           "gigl_tpu/models/convs.py:292", max(v["err"] for v in k7.values()),
           k7["gat"]["ms"], k7["gat"]["plain_ms"],
           nbytes=k7["gat"]["nbytes"], nops=k7["gat"]["nops"],
           library_ms=cuda_ms(sdpa),
           library_call="F.scaled_dot_product_attention, memory-efficient "
                        "backend (Transformer mode; K/V gathered "
                        "beforehand, gather not timed); the GAT modes have "
                        "no single-call counterpart",
           bucket=[n_b, w_b], heads=GAT_HEADS, head_dim=dh7,
           eager_ms=k7["gat"]["eager_ms"],
           loads_ahead=loads_ahead(),
           modes={m_: {k_: v_ for k_, v_ in v.items()
                       if k_ not in ("nbytes", "nops")}
                  for m_, v in k7.items()})
    del x6, adj, xd7, ks7, vs7, k_s, v_s

    # the two full-width passes, each through the user's entry point
    def encode_plain(enc, x_, ell_):
        """The pass again through the plain versions only."""
        h_ = x_.to(torch.bfloat16)[ell_.perm.long()]
        for li, conv in enumerate(enc.convs):
            src_ = (h_ if isinstance(conv, SAGEConv)
                    else linear(conv.lin_src, h_, conv.dtype))
            outs = []
            for b_ in range(len(ell_.widths)):
                lo_, hi_ = ell_.boundaries[b_], ell_.boundaries[b_ + 1]
                if hi_ == lo_:
                    continue
                dst_, nb_, mk_ = h_[lo_:hi_], ell_.nbr[b_], ell_.mask[b_]
                if isinstance(conv, SAGEConv):
                    outs.append(conv._combine(dst_, _ell_aggregate_plain(
                        src_, nb_, mk_, conv.aggr)))
                else:
                    check(isinstance(conv, GATConv) and not conv.v2,
                          "encode_plain covers SAGE and GAT v1")
                    hd_ = linear(conv.lin_dst, dst_, conv.dtype)
                    outs.append(conv._finish(_fanout_attention_plain(
                        hd_, src_, src_, nb_, mk_, "gat", conv.heads,
                        conv.att_src.reshape(-1), conv.att_dst.reshape(-1),
                        conv.negative_slope)))
            h_ = torch.cat(outs)
            if li < len(enc.convs) - 1:
                h_ = torch.relu(h_)
        return h_[ell_.rank.long()]

    x_full = x
    launches_fg, fg_rows = {}, {}
    for model_name, kw in (("graphsage", None), ("gat", {"heads": GAT_HEADS})):
        enc = GNNEncoder(D, HID, OUT, num_layers=2, conv=model_name,
                         conv_kwargs=kw, dtype=torch.bfloat16)
        init_params(enc, 0)
        sink = Sink()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        _build.reset_launches()
        t0 = time.perf_counter()
        total = run_full_graph_inference(enc, None, graph, sink, device=dev)
        torch.cuda.synchronize()
        pass_s = time.perf_counter() - t0
        launches_fg[model_name] = dict(_build.launches)
        peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
        emit({"phase": "main_path", "path": f"full_graph_{model_name}",
              "launches": launches_fg[model_name], "seconds": pass_s})
        for kname in FULL_GRAPH_KERNELS[model_name]:
            check(launches_fg[model_name][kname] > 0,
                  f"{kname} was not launched on the {model_name} "
                  "full-graph path")
        if model_name == "graphsage":
            check(launches_fg[model_name]["ell_aggregate"] == 2,
                  "K6 launched "
                  f"{launches_fg[model_name]['ell_aggregate']} times in the "
                  "two-layer full-graph pass, not once a layer")
        ids = np.concatenate(sink.ids)
        embs = np.concatenate(sink.embs)
        check(total == N and ids.shape == (N,)
              and np.array_equal(np.sort(ids), np.arange(N)),
              f"{model_name}: exported ids are not every node exactly once")
        check(embs.shape == (N, OUT) and np.isfinite(embs).all(),
              f"{model_name}: embeddings are not finite [N, {OUT}]")
        order = np.argsort(ids)
        with torch.inference_mode():
            ref_fg = encode_plain(enc, x_full, ell).float().cpu().numpy()
            scale_fg = float(np.abs(ref_fg).max())
            err_fg = float(np.abs(embs[order] - ref_fg).max())
            check(err_fg <= 2e-2 * scale_fg,
                  f"{model_name} full-graph pass differs from the plain "
                  f"recomputation: {err_fg} vs {scale_fg}")
            del ref_fg
            enc.encode_ell(x_full, ell)          # warm
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                enc.encode_ell(x_full, ell)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            encode_ms = float(np.median(times)) * 1e3
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(FULL_GRAPH_PROFILED):
                    enc.encode_ell(x_full, ell)
                torch.cuda.synchronize()
                window_us = (time.perf_counter() - t0) * 1e6
        edges_pass = 2 * E          # each of the 2 layers aggregates every edge
        fg_rows[model_name] = {
            "max_abs_err": err_fg, "scale": scale_fg,
            "entry_point_s": pass_s, "encode_ms": encode_ms,
            "encode_ms_runs": [t_ * 1e3 for t_ in times],
            "nodes_per_s": N / (encode_ms / 1e3),
            "edges_per_pass": edges_pass,
            "edges_per_s": edges_pass / (encode_ms / 1e3),
            "peak_mem_gb": peak_gb,
            "profile": profile_summary(prof, FULL_GRAPH_PROFILED, window_us,
                                       encode_ms)}
        emit({"phase": "full_graph_throughput", "model": model_name,
              "ell_build_s": ell_build_s, **fg_rows[model_name],
              "card": card})
        del enc, sink, embs

    # -- node classification: the backward kernels, then the two paths -------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fb_data = full_batch_data_from_graph(graph, device=dev)
    torch.cuda.synchronize()
    fb_data_s = time.perf_counter() - t0
    fell = fb_data.ell
    t_nonempty = sum(hi > lo for lo, hi in zip(fell.t_boundaries,
                                               fell.t_boundaries[1:]))
    t_slots = sum(int(r_.numel()) for r_ in fell.t_row)
    n_ent = int(fell.ent_row.shape[0])
    valid_ent = torch.cat([m_.reshape(-1) for m_ in fell.mask])
    src_ent = torch.cat([nb_.reshape(-1) for nb_ in fell.nbr]).long()
    n_valid = int(valid_ent.sum())
    dst_rows = int((fell.deg_p > 0).sum())
    emit({"phase": "full_batch_data", "seconds": fb_data_s,
          "train": int(fb_data.train_mask.sum()),
          "val": int(fb_data.val_mask.sum()),
          "test": int(fb_data.test_mask.sum()),
          "t_widths": list(fell.t_widths),
          "rows_per_t_bucket": [hi - lo for lo, hi in zip(
              fell.t_boundaries, fell.t_boundaries[1:])],
          "t_slots": t_slots, "entries": n_ent, "valid_entries": n_valid})
    check(n_valid == E, "the ELL entries are not the graph's edges")

    # K6b over the whole transpose walk, layer 2's [100k, 256] fp32
    # cotangent. bytes: each dst row with an in-edge read once, t_row (a
    # slot's composed row id, 4 bytes a transpose slot), the degree and
    # t_perm tables, [N, 256] written (weighted, gatv2: + t_nbr, the slot's
    # flat entry, and two fp32 per valid entry and head); ops: one
    # multiply-add per valid entry and value.
    gen8 = torch.Generator(device=dev).manual_seed(8)
    g6 = torch.randn((N, HID), generator=gen8, device=dev)
    wt6 = torch.rand((n_ent, GAT_HEADS), generator=gen8, device=dev) * 0.1
    wt6b = torch.randn((n_ent, GAT_HEADS), generator=gen8, device=dev) * 0.1
    vec6 = torch.randn(HID, generator=gen8, device=dev) * 0.2
    k6b_bytes = dst_rows * HID * 4 + t_slots * 4 + N * 8 + N * HID * 4
    q6, t6 = (torch.randn((N, HID), generator=gen8, device=dev)
              for _ in range(2))
    x6m = (t6 * 2).round()       # a coarse grid: the max has ties
    max6 = ell_aggregate_graph(x6m, fell, "max")
    k6b = {}
    for mode, extra in (("mean", ()), ("gcn", ()),
                        ("max", (None, None, None, 1, max6, x6m)),
                        ("weighted", (wt6, wt6b, vec6, GAT_HEADS)),
                        ("gatv2", (wt6, wt6b, vec6, GAT_HEADS, q6, t6))):
        def k6b_kernel(mode=mode, extra=extra):
            return ell_transpose_aggregate(g6, fell, mode, *extra)

        def k6b_plain(mode=mode, extra=extra):
            return _ell_transpose_plain(g6, fell, mode, *extra)

        err = rel_err(k6b_kernel(), k6b_plain(), f"K6b {mode}", tol=1e-5)
        # weighted: + two fp32 per valid entry and head; GATv2: + the query
        # rows (as many as the cotangent rows) and the key table; max: + the
        # forward's max rows, its input table and the fp32 tie counts (the
        # tie-count pass reads the forward tables: nbr and mask)
        nbytes = k6b_bytes + (t_slots * 4 + n_valid * GAT_HEADS * 8
                              + HID * 4
                              if mode in ("weighted", "gatv2") else 0) + (
            dst_rows * HID * 4 + N * HID * 4 if mode == "gatv2" else 0) + (
            N * HID * 4 * 4 + n_ent * 5 if mode == "max" else 0)
        k6b[mode] = {"err": err, "ms": cuda_ms(k6b_kernel),
                     "plain_ms": cuda_ms(k6b_plain, reps=1),
                     "eager_ms": eager_ms(k6b_kernel),
                     "bound_ms": bound_ms(nbytes, n_valid * HID * 2)[0]}
    # the atomics version: index_add_ of the mean's weighted cotangent rows
    # (gathered and weighted beforehand, not timed)
    erow = fell.ent_row.long()[valid_ent]
    msg6 = g6[erow] / fell.deg_p[erow].clamp(min=1.0)[:, None]
    src_v = src_ent[valid_ent]

    def k6b_library():
        return torch.zeros((N, HID), device=dev).index_add_(0, src_v, msg6)

    rel_err(k6b_library(), ell_transpose_aggregate(g6, fell, "mean"),
            "index_add_ yardstick vs K6b mean", tol=1e-5)
    record("ell_transpose_aggregate", "gigl_tpu_torch/csrc/ell_transpose.cu",
           "gigl_tpu/ops/ell.py:255", max(v["err"] for v in k6b.values()),
           k6b["mean"]["ms"], k6b["mean"]["plain_ms"], nbytes=k6b_bytes,
           nops=n_valid * HID * 2, library_ms=cuda_ms(k6b_library),
           library_call="torch.Tensor.index_add_ of the weighted cotangent "
                        "rows (atomics; gather and weighting not timed)",
           table=[N, HID], dtype="float32", t_launches=t_nonempty,
           eager_ms=k6b["mean"]["eager_ms"], modes=k6b,
           gathered_bytes=n_valid * HID * 4)
    del msg6, src_v, erow, wt6, wt6b, q6, t6, x6m, max6

    # K7b at the largest bucket, fp32: GAT layer 1 (H=4, Dh=64), GAT layer
    # 2 (Dh=4) and Transformer. bytes: g, xd and out rows, each distinct
    # source row of ks (and vs) read once, nbr, mask and the softmax
    # statistics, d_xd and the per-entry alpha and coefficient written;
    # ops per valid slot and value: logit 2, g·v 2, the d_xd / d_att_src
    # share 2.
    nb_f, mk_f = fell.nbr[big], fell.mask[big]
    nf_b, wf_b = nb_f.shape
    validf = int(mk_f.sum())
    uniqf = unique(nb_f[mk_f])
    k7b = {}
    for label, mode, hd_ in (("gat_dh64", "gat", HID),
                             ("gat_dh4", "gat", C),
                             ("gatv2_dh64", "gatv2", HID),
                             ("transformer_dh64", "transformer", HID)):
        dh_ = hd_ // GAT_HEADS
        xd_, ks_, vs_, g_ = (torch.randn(s_, generator=gen8, device=dev)
                             for s_ in ((nf_b, hd_), (N, hd_), (N, hd_),
                                        (nf_b, hd_)))
        a1 = a2 = None
        if mode != "transformer":
            vs_ = ks_
            a1, a2 = (torch.randn(hd_, generator=gen8, device=dev) * 0.3
                      for _ in range(2))
            a2 = a2 if mode == "gat" else None
        st_ = torch.empty((nf_b, GAT_HEADS, 2), device=dev)
        out_ = _fanout_attention_fwd(xd_, ks_, vs_, nb_f, mk_f, mode,
                                     GAT_HEADS, a1, a2, 0.2, stats=st_)

        def k7b_kernel(mode=mode, xd_=xd_, ks_=ks_, vs_=vs_, g_=g_, a1=a1,
                       a2=a2, out_=out_, st_=st_):
            return fanout_attention_bwd(g_, xd_, ks_, vs_, nb_f, mk_f, out_,
                                        st_, mode, GAT_HEADS, a1, a2, 0.2)

        def k7b_plain(mode=mode, xd_=xd_, ks_=ks_, vs_=vs_, g_=g_, a1=a1,
                      a2=a2, out_=out_):
            return _fanout_attention_bwd_plain(g_, xd_, ks_, vs_, nb_f, mk_f,
                                               out_, mode, GAT_HEADS, a1, a2,
                                               0.2)

        got_, want_ = k7b_kernel(), k7b_plain()
        # fp32 exps and sums in another order; d_logit = alpha (g·v - g·out)
        # cancels: within 1e-4 of each output's scale
        err = max(rel_err(getattr(got_, f_), getattr(want_, f_),
                          f"K7b {label} {f_}", tol=1e-4)
                  for f_ in ("d_xd", "alpha", "coef", "d_att")
                  if getattr(want_, f_) is not None)
        tables = 2 if mode == "transformer" else 1
        nbytes = (3 * nf_b * hd_ * 4 + uniqf * hd_ * 4 * tables
                  + nf_b * wf_b * 5 + nf_b * GAT_HEADS * 8
                  + nf_b * wf_b * GAT_HEADS * 8 + nf_b * hd_ * 4)
        nops = validf * hd_ * 6
        row7 = {"err": err, "ms": cuda_ms(k7b_kernel),
                "plain_ms": cuda_ms(k7b_plain, reps=1),
                "eager_ms": eager_ms(k7b_kernel),
                "bound_ms": bound_ms(nbytes, nops)[0], "nbytes": nbytes,
                "nops": nops, "head_dim": dh_}
        if mode == "transformer":
            # SDPA's backward (memory-efficient backend) on pre-gathered
            # K / V with the boolean mask: one PyTorch call, timed eagerly
            q_s = xd_.reshape(nf_b, GAT_HEADS, 1, dh_).requires_grad_()
            k_s, v_s = (t_[nb_f.long()].reshape(nf_b, wf_b, GAT_HEADS, dh_)
                        .transpose(1, 2).contiguous().requires_grad_()
                        for t_ in (ks_, vs_))
            with torch.nn.attention.sdpa_kernel(
                    [torch.nn.attention.SDPBackend.EFFICIENT_ATTENTION]):
                o_s = F.scaled_dot_product_attention(
                    q_s, k_s, v_s, attn_mask=mk_f[:, None, None, :])
            g_s = g_.reshape(nf_b, GAT_HEADS, 1, dh_)
            row7["library_ms"] = eager_ms(lambda: torch.autograd.grad(
                o_s, (q_s, k_s, v_s), g_s, retain_graph=True), reps=10)
            del q_s, k_s, v_s, o_s
        k7b[label] = row7
        del xd_, ks_, vs_, g_, out_, st_, got_, want_
    record("fanout_attention_bwd",
           "gigl_tpu_torch/csrc/fanout_attention_bwd.cu",
           "gigl_tpu/models/convs.py:292", max(v["err"] for v in k7b.values()),
           k7b["gat_dh64"]["ms"], k7b["gat_dh64"]["plain_ms"],
           nbytes=k7b["gat_dh64"]["nbytes"], nops=k7b["gat_dh64"]["nops"],
           library_ms=None,
           library_call="GAT modes: none (no single call computes them); "
                        "Transformer mode: modes.transformer_dh64.library_ms "
                        "= SDPA backward, memory-efficient backend, K/V "
                        "gathered beforehand, timed eagerly",
           bucket=[nf_b, wf_b], heads=GAT_HEADS, dtype="float32",
           eager_ms=k7b["gat_dh64"]["eager_ms"],
           loads_ahead=loads_ahead(),
           modes={m_: {k_: v_ for k_, v_ in v.items()
                       if k_ not in ("nbytes", "nops")}
                  for m_, v in k7b.items()})

    def run_path(path, trainer, state, steps, warmup, profiled, kernels,
                 nodes=None, reset=True, must_fall=True):
        """``warmup`` + ``steps`` steps with the launch counts reset just
        before (unless the caller reset them before building the trainer:
        ``reset=False``) and read just after, then ``profiled`` more under
        torch.profiler. ``must_fall``: the last five losses' mean below the
        first five's (not for an objective that need not fall in a few
        steps: random labels, self-supervised views)."""
        def step(st, k):
            if nodes is None:
                return trainer.train_step(st)
            return trainer.train_step(st, nodes[k])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        if reset:
            _build.reset_launches()
        for k in range(warmup):
            state, _ = step(state, k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        with timed_window(path):
            for k in range(warmup, warmup + steps):
                state, loss = step(state, k)
                losses.append(loss)
            torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / steps
        counts = dict(_build.launches)
        peak_gb = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
        emit({"phase": "main_path", "path": path, "launches": counts,
              "steps": warmup + steps})
        for kname in kernels:
            check(counts[kname] > 0, f"{kname} was not launched on the "
                  f"{path} path")
        losses = torch.stack(losses).float().cpu().numpy()
        check(np.isfinite(losses).all(), f"{path}: loss not finite")
        first, last = float(losses[:5].mean()), float(losses[-5:].mean())
        check(last < first or not must_fall,
              f"{path}: loss did not fall: {first} -> {last}")
        with timed_window(path), torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for k in range(warmup + steps, warmup + steps + profiled):
                state, _ = step(state, k)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        return counts, warmup + steps, {
            "steps": steps, "ms_per_step": step_s * 1e3,
            "loss_first5": first, "loss_last5": last,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "peak_mem_gb": peak_gb,
            "profile": profile_summary(prof, profiled, window_us,
                                       step_s * 1e3), "card": card}

    nc_launches = {}                 # path -> (launch counts, steps)
    for model_name, kw in (("graphsage", None), ("gat", {"heads": GAT_HEADS})):
        path = f"full_batch_{model_name}"
        fbt = FullBatchTrainer(
            GNNEncoder(D, HID, C, num_layers=2, conv=model_name,
                       conv_kwargs=kw), fb_data,
            optimizer_args={"learning_rate": "1e-2"}, device=dev)
        state = fbt.init_state(0)
        vs = step_vs_plain(fbt.encoder, fbt.loss, _build.launches)
        emit({"phase": "full_batch_step_vs_plain", "model": model_name,
              **vs})
        # fp32: the same sums in another order
        check(vs["loss_rel_err"] <= 1e-5,
              f"{path}: loss differs from the plain step: {vs}")
        check(vs["max_grad_err_rel_to_scale"] <= 1e-4,
              f"{path}: a gradient differs from the plain step: {vs}")
        counts, nsteps, row = run_path(path, fbt, state, FB_STEPS, FB_WARMUP,
                                       FB_PROFILED,
                                       FULL_BATCH_KERNELS[model_name])
        nc_launches[path] = (counts, nsteps)
        if model_name == "graphsage":
            check(counts["ell_aggregate"] == 2 * nsteps,
                  f"K6 launched {counts['ell_aggregate']} times in "
                  f"{nsteps} steps, not once a layer")
            # layer 2's aggregate only: layer 1's input needs no gradient
            check(counts["ell_transpose_aggregate"] == t_nonempty * nsteps,
                  f"K6b launched {counts['ell_transpose_aggregate']} times, "
                  f"not {t_nonempty} per step (layer 2 only)")
        step_s = row["ms_per_step"] / 1e3
        emit({"phase": "full_batch_train_throughput", "model": model_name,
              "edges_per_step": 2 * E, "edges_per_s": 2 * E / step_s,
              "nodes_per_s": N / step_s, **row})
        del fbt, state

    # a labeled set of NC_LABELED batches, cycled: semi-supervised node
    # classification trains on few labels (milestone 2 on 1,600), and with
    # random labels only the labeled nodes' loss can fall
    labeled = np.random.default_rng(1).permutation(N)[
        : NC_BATCH * NC_LABELED].reshape(NC_LABELED, NC_BATCH)
    nc_nodes = labeled[np.arange(NC_WARMUP + NC_STEPS + NC_PROFILED)
                       % NC_LABELED].astype(np.int32)
    for model_name, (layers, fanouts, kw) in NC_MODELS.items():
        path = f"nc_sampled_{model_name}"
        nct = NodeClassificationTrainer(
            GNNEncoder(D, NC_HID, C, num_layers=layers, conv=model_name,
                       conv_kwargs=kw), dg,
            NodeClassificationTrainerConfig(fanouts=fanouts),
            optimizer_args={"learning_rate": NC_LR}, device=dev)
        state = nct.init_state(0)
        vs = step_vs_plain(nct.model, lambda: nct.loss(nc_nodes[0]),
                           _build.launches)
        emit({"phase": "nc_sampled_step_vs_plain", "model": model_name,
              "fanouts": list(fanouts), **vs})
        check(vs["loss_rel_err"] <= 1e-5,
              f"{path}: loss differs from the plain step: {vs}")
        check(vs["max_grad_err_rel_to_scale"] <= 1e-4,
              f"{path}: a gradient differs from the plain step: {vs}")
        counts, nsteps, row = run_path(path, nct, state, NC_STEPS, NC_WARMUP,
                                       NC_PROFILED, NC_KERNELS[model_name],
                                       nodes=nc_nodes)
        nc_launches[path] = (counts, nsteps)
        acc = nct.evaluate(labeled.reshape(-1), NC_BATCH)
        check(0.0 <= acc <= 1.0, f"{path}: accuracy {acc}")
        emit({"phase": "nc_sampled_train_throughput", "model": model_name,
              "fanouts": list(fanouts), "batch": NC_BATCH,
              "seeds_per_s": NC_BATCH / (row["ms_per_step"] / 1e3),
              "labeled_nodes": int(labeled.size), "train_accuracy": acc,
              **row})
        del nct, state

    coo, coo_ms, walk = coo_phases(dev, card, graph, record, rel_err,
                                   unique, run_path)
    typed, typed_ctx = typed_phases(dev, card, record, rel_err, unique)
    tt_steps = TT_WARMUP + TT_STEPS

    def add_mode(kname, mode, entry):
        """One more mode's numbers on a kernel row recorded above."""
        row_ = next(r_ for r_ in results if r_["name"] == kname)
        row_.setdefault("modes", {})[mode] = entry

    for kname, modes in walk.items():
        for mode, entry in modes.items():
            add_mode(kname, mode, entry)
    edge = edge_phases(
        dev, card, (src, dst, np.asarray(graph.node_features[
            graph.metadata.node_types[0]])), fb_data, typed_ctx, record,
        add_mode, rel_err, unique, run_path)
    quant = quantized_phases(dev, card, graph, np.stack([src, dst]), record,
                             add_mode, unique, make_model, opt_args, anchors,
                             (dg, cfg))
    part, part_trainer = partitioned_phases(dev, card, dg, record, add_mode,
                                            unique, make_model, opt_args)
    sharded = sharded_phases(
        dev, card, (src, dst, np.asarray(graph.node_features[
            graph.metadata.node_types[0]]), np.asarray(graph.node_labels[
                graph.metadata.node_types[0]])),
        [m_.cpu().numpy() for m_ in (fb_data.train_mask, fb_data.val_mask,
                                     fb_data.test_mask)],
        record, unique, coo_ms, part_trainer)
    del part_trainer
    weighted = weighted_phases(
        dev, card, (src, dst, np.asarray(graph.node_features[
            graph.metadata.node_types[0]])), record, add_mode, unique,
        make_model, opt_args, cfg, ms_step, typed_ctx, rel_err)
    coo_edge, coo_edge_modes = coo_edge_phases(
        dev, card, graph, np.random.default_rng(8).normal(
            size=(E, EDGE_DE)).astype(np.float32), fb_data.ell, record,
        add_mode, rel_err, unique, run_path)
    for kname, by_mode in coo_edge_modes.items():
        for mode, entry in by_mode.items():
            add_mode(kname, mode, entry)
    part_tab = partitioned_tabularized_phases(dev, card, dg, record,
                                              add_mode, unique, make_model,
                                              opt_args)
    label_edge = partitioned_label_edge_phases(
        dev, card, graph, (src, dst), typed_ctx, add_mode, unique, opt_args)
    stream = streaming_phases(
        dev, card, (src, dst, np.asarray(graph.node_features[
            graph.metadata.node_types[0]])), dg)
    stream_part = streamed_partitioned_phases(
        dev, card, (src, dst, np.asarray(graph.node_features[
            graph.metadata.node_types[0]]), np.asarray(graph.node_labels[
                graph.metadata.node_types[0]])), dg, typed_ctx, add_mode)
    options = option_phases(dev, card, dg, run_path, opt_args, cfg, anchors)
    link = link_task_phase(dev, card, dg, (src, dst), run_path, opt_args)
    ssl = ssl_phases(dev, card, dg, run_path, opt_args, anchors)

    # launches on every kernel row: the training path's (K6 / K7: the
    # full-graph passes'; K6b / K7b: the node-classification paths'; K8-K10:
    # the exact typed passes'; K8b-K10b: the COO full-batch paths'), and
    # per pass or step of each other path
    per_pass = {"sample_uniform": 1, "build_neighbor_cache": 1,
                "gather_rows": n_batches, "masked_reduce": n_batches}
    for row in results:
        k = row["name"]
        fg = {m_: launches_fg[m_][k] for m_ in launches_fg}
        nc = {p_: c_[k] for p_, (c_, _) in nc_launches.items()}
        if k in TRAINING_KERNELS:
            row["launches"] = launches[k]
        elif k in ("ell_transpose_aggregate", "fanout_attention_bwd"):
            row["launches"] = sum(nc.values())
        elif k in ("segment_reduce", "segment_softmax", "sddmm"):
            row["launches"] = sum(typed[p_][k] for p_ in typed
                                  if p_.startswith("typed_full"))
        elif k in ("segment_reduce_bwd", "segment_softmax_bwd", "sddmm_bwd"):
            row["launches"] = sum(c_[k] for c_, _ in coo.values())
        elif k == "ell_edge_grad":
            row["launches"] = sum(c_[k] for p_, (c_, _) in edge.items()
                                  if p_.startswith("edge_full_batch"))
        elif k in ("gather_rows_q8", "cms_add", "cms_estimate"):
            row["launches"] = quant["quantized_train"][0][k]
        elif k in ("route_requests", "unroute_rows"):
            row["launches"] = part["partitioned_train"][0][k]
        elif k == "ring_retrieval":
            row["launches"] = part["partitioned_ring_train"][0][k]
        elif k == "ring_spmm":
            row["launches"] = sum(c_[k] for p_, (c_, _) in sharded.items()
                                  if p_.startswith("sharded_"))
        elif k == "sample_weighted":
            row["launches"] = weighted["weighted_tabularized_train"][0][k]
        else:
            row["launches"] = sum(fg.values())
        row["launches_per_step"] = (launches[k] - after_init[k]) / (
            WARMUP + STEPS)
        row["launches_inference"] = launches_inf[k]
        row["launches_per_inference_pass"] = launches_inf[k] / per_pass.get(
            k, 1)
        row["launches_per_full_graph_pass"] = fg
        row["launches_per_nc_step"] = {
            p_: c_[k] / n_ for p_, (c_, n_) in nc_launches.items()}
        row["launches_per_coo_step"] = {
            p_: c_[k] / n_ for p_, (c_, n_) in coo.items()}
        row["launches_per_typed_pass"] = {
            p_: c_[k] for p_, c_ in typed.items()
            if not p_.startswith("typed_train")}
        row["launches_per_typed_train_step"] = {
            p_: c_[k] / tt_steps for p_, c_ in typed.items()
            if p_.startswith("typed_train")}
        row["launches_per_edge_path_step"] = {
            p_: c_[k] / n_ for p_, (c_, n_) in edge.items()}
        row["launches_per_quantized_path_step"] = {
            p_: c_[k] / n_ for p_, (c_, n_) in quant.items()}
        row["launches_per_partitioned_step"] = {
            p_: c_[k] / n_ for p_, (c_, n_) in part.items()}
        row["launches_per_sharded_step"] = {
            p_: c_[k] / n_ for p_, (c_, n_) in sharded.items()}
        row["launches_per_weighted_path_step"] = {
            p_: c_[k] / n_ for p_, (c_, n_) in weighted.items()}
        row["launches_per_coo_edge_step"] = {
            p_: c_[k] / n_ for p_, (c_, n_) in coo_edge.items()}
        row["launches_per_partitioned_tabularized_path_step"] = {
            p_: c_[k] / n_ for p_, (c_, n_) in part_tab.items()}
        row["launches_per_label_edge_and_typed_partitioned_step"] = {
            p_: c_[k] / n_ for p_, (c_, n_) in label_edge.items()}
        row["launches_per_streaming_step"] = {
            p_: c_[k] / n_ for p_, (c_, n_) in stream.items()}
        row["launches_per_streamed_partitioned_step"] = {
            p_: c_[k] / n_ for p_, (c_, n_) in stream_part.items()}
        row["launches_per_option_link_ssl_step"] = {
            p_: c_[k] / n_ for p_, (c_, n_) in {**options, **link,
                                                **ssl}.items()}
    for kname, mode in (("unroute_rows", "int8_decode"),
                        ("gather_rows_q8", "packed_rows"),
                        ("gather_rows", "bytes_21")):
        counter = {"int8_decode": "unroute_rows_q8",
                   "packed_rows": "gather_rows_q8_packed",
                   "bytes_21": "gather_rows_bytes"}[mode]
        next(r_ for r_ in results if r_["name"] == kname)["modes"][mode][
            "launches_per_path"] = {p_: c_[counter] for p_, (c_, _)
                                    in part_tab.items()}
    for kname, mode, counter in (("ring_retrieval", "own_block_bias",
                                  "ring_retrieval_bias"),
                                 ("unroute_rows", "edge_rows",
                                  "unroute_rows")):
        next(r_ for r_ in results if r_["name"] == kname)["modes"][mode][
            "launches_per_path"] = {p_: c_[counter] for p_, (c_, _)
                                    in label_edge.items() if c_[counter]}
    check(len(results) == len(_build.KERNEL_NAMES) == 26,
          "the kernels line does not list all twenty-six kernels")
    emit({"phase": "host_index_builds",
          "in_timed_windows": INDEX_BUILDS_IN_WINDOWS,
          "calls_in_run": HOST_INDEX_BUILDS["calls"],
          "k8_gather_launches_in_timed_windows": K8_GATHER_IN_WINDOWS,
          "k8b_walk_launches_in_timed_windows": K8B_WALK_IN_WINDOWS})
    segment_paths = list(coo) + list(coo_edge) + [
        f"typed_full_{m_}" for m_ in TYPED_FULL_KERNELS]
    check(all(p_ in INDEX_BUILDS_IN_WINDOWS for p_ in segment_paths),
          "a segment path's timed window was not watched for host builds")
    check(all(K8_GATHER_IN_WINDOWS[p_]["composed"] > 0
              for p_ in segment_paths),
          "a segment path's timed window ran no composed K8 launch")
    check(all(K8B_WALK_IN_WINDOWS[p_]["composed"] > 0
              for p_ in list(coo) + list(coo_edge)),
          "a COO step's timed window ran no composed K8b launch")
    results.sort(key=lambda r: _build.KERNEL_NAMES.index(r["name"]))

    emit({"kernels": results})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
