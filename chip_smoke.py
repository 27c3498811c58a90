"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Phases, in order; any failure propagates and the exit code is not 0:

  1. device   card name, count and nvidia-smi's name and power limit;
              TF32 off for matmuls and cuDNN
  2. build    nvcc builds euler_tpu_torch/csrc/fan_draw.cu,
              gather_rows.cu, ell_agg.cu and ell_attn.cu, and g++ the
              native host core
              (euler_tpu_torch/csrc/euler_core.cc), all from this
              checkout and all at once; the run fails unless the core
              loaded from the package's own source, and the build: line
              names that source and its library; beside them one more
              nvcc build of each .cu with -Xptxas -v logs every kernel's
              registers, shared memory and spills, by mangled name. With
              --parent DIR (a copy of the parent commit's tree, e.g. from
              git archive), the parent's fan_draw, gather_rows and GAT
              kernels are built from DIR too, and its four .cu files'
              ptxas figures logged beside this checkout's
  3. kernel   fan_draw against its plain PyTorch version at the two hop
              shapes of the path (B=1024, C=25) and (B=26,624, C=10), a
              ragged B, one draw (1, 1), more draws than lanes (333, 50),
              one row past a block's rows (4097, 10) and a 3-type pack
              whose rows past the pack clamp, on fan rows covering degree
              0..42, reservoir rows, zero weight sums and node -1; ids and
              valid must be equal bit for bit, from the wrapper and from
              each of the kernel's two paths (row, draw) at every shape.
              Timed at the hop shapes with CUDA events, L2 flushed between
              launches, and both paths (with --parent also the parent's
              kernel) in turns: parent, row, draw, draw, row, parent. The
              two paths again, bit-exact and in turns, at B = 1024, 2048,
              4096, 8192, 12,800 and 26,624 with C = 10, 15, 20 and 25:
              where one overtakes the other. Then an empty launch timed the same
              way, the launch floor
 3b. union    fan_draw's typed and union epilogue against its plain
              version, bit for bit (ids, valid and types), from the
              wrapper and from each path, at both hop shapes: union rows
              with types 0..15, ids up to FANU_MASK, reservoir rows, zero
              weight sums and node -1 (with and without types), and the
              one-type typed output on a 2-type pack whose rows past the
              pack clamp. The union draw with types timed (CUDA events, L2
              flushed) beside its plain version and its bytes bound, and
              in turns with the untyped draw: untyped, union, union,
              untyped
  4. gather   gather_rows against its plain version, bit for bit (NaN rows
              compared as integers, and exactly where ids >= N): the
              deepest feature gather (M=292,864, D=128 from [200,000, 128])
              in f32 and bf16, the label gather (1024, 16) in both, ragged
              widths D = 1, 3, 127 (f32) and 5 (bf16), column offsets into
              wider outputs on the 16-byte and the element path, M = 1, 33
              and 1000, and ids all -1, all >= N and heavily repeated. At
              the two 292,864-row shapes also the kernel's, the plain
              version's and torch.index_select's times (CUDA events, L2
              flushed) and the bytes bound; the kernel's time on the same
              ids sorted, and on M ids with no repeat from a table of 2N
              rows (with its own bound), each bit-exact; and with --parent
              the parent's kernel, bit-exact, and this one in turns. The
              whole-graph gcn gathers too: ids arange(N) over
              [100,000, 128] (f32 and bf16, timed with the bound, the
              plain version, index_select and a copy) and [100,000, 16]
  5. graph    random_graph(200_000, 25, feat_dim=128, n_classes=16, seed=0,
              packs=("fan",)) on the card
  6. model    bench.make_model("sage"): SuperviseModel(GNNNet("sage",
              SageDataFlow([25, 10], ...), dims=(128, 128)), "label", 16),
              weights from a seeded generator
  7. infer    NodeEstimator.infer(arange(8192)), batch 1024: the serving
              path: the first batch eager, the second captured in a
              CUDA graph, the second to the eighth served by replays of
              it (7 ``infer_replays``). The launch counts are set to 0
              before and must be 16 for fan_draw (2 hops x 8 batches)
              and 16 for gather_rows (features and labels x 8 batches)
              after; embeddings finite [8192, 128], within 1e-4 of the
              largest of the eager forward's, its draws equal to the
              eager forward's bit for bit (each family's and conv's
              infer likewise). Then the steady forward time per batch,
              and a torch.profiler table of CUDA time by kernel over two
              more batches
  8. parity   one batch through the port on the card and on the CPU with
              the same weights and uniforms: equal sampled ids, embeddings
              within rtol = atol = 1e-4 (f32, different summation order)
  9. serve    serve_embeddings on 127.0.0.1: /healthz, /embedding, /knn by
              id and by vector, each checked
 10. train    NodeEstimator.train(8 steps) at full width with a reservoir
              redraw every 3 steps: the training path. The counts are set
              to 0 before and must be 2 per step for each kernel after; the
              loss finite, the roots in [0, N), and the two redraws must
              have rewritten only the kept and alias lanes of the reservoir
              rows (fan_over_rows), with neighbors of each row's group.
              Then a torch.profiler table over two more steps
 11. grads    one training step on the card and on the CPU from the same
              weights, roots and uniforms (f32, TF32 off): equal sampled
              ids, loss and the gradient of every parameter within
              rtol = atol = 1e-4
 12. families gin, gat and rgcn (bench.make_model, f32) at full width,
              gin and gat on the graph of phase 5, rgcn on
              random_graph(200_000, 25, ..., num_edge_types=4,
              packs=("fanu",)): for each, phases 7, 10 and 11 as above
              (infer of 8192 ids with 16 launches of each kernel, two
              batches profiled; one step card vs CPU with equal sampled
              ids and edge types; 8 train steps with 2 launches of each
              kernel a step and the redraw of the graph's reservoir rows,
              for rgcn the union rows, two steps profiled)
 12b. gcn    bench.py's whole-graph gcn mode (bench.make_model("gcn"),
              f32) on random_graph(100_000, 25, feat_dim=128,
              n_classes=16, seed=0, packs=("ell",)), whose ELL pack must be
              53 wide with a 49-wide transpose: infer of 8192 ids (16
              gather_rows and 16 ell_agg launches, no fan_draw) and two
              batches profiled; one step on the card and on the CPU (blocks
              equal, loss and every gradient within 1e-4); the forward on
              the ELL pack against the edge list on the card (within
              1e-4); 8 train steps over every node (2 gather_rows and 3
              ell_agg launches a step, losses finite, peak memory) and two
              profiled; ops.ell_agg alone in both modes (forward, and the
              transpose that is the gradient to x) at D = 128 and 256 in
              bf16 and f32, held to its plain version, beside its bytes
              bound, the plain version's time and, in f32, torch.sparse.mm,
              on this graph's block and on the gcn-train cell's (the
              benchmark's own graph, benchmark/configs/gcn.json: 169,343
              nodes, C = C_in = 36); two steps of the bench's bf16 model
              profiled, with peak memory
 12c. transe bench.py's transe mode (f32) on random_graph(100_000, 25,
              seed=0, num_edge_types=16, packs=()), whose edge alias
              tables (17 type offsets) must be on the card: sample_edge
              card vs CPU bit for bit on the same graph moved with .to
              (counts 1, 4096 and 4097, every type and type 3);
              EdgeEstimator(TransE at 100 wide, 5 negatives, batch 4096,
              Adam 1e-3): 8 train steps, one step card vs CPU (loss and
              every gradient within 1e-4), evaluate (mrr) of 4096 sampled
              triples, evaluate_ranking of 64 triples both ways,
              unfiltered and filtered by 100,000 sampled triples, ranks
              card vs CPU equal but for near ties (candidates within
              twice the 1e-4 card-vs-CPU tolerance of the true score,
              whose scores must agree within it), infer of 8192
              triples; TransH, TransR, TransD and DistMult at the same
              width, the forward card vs CPU within 1e-4 and one step
              each; neither kernel launched in the whole phase; two steps
              profiled, with peak memory
 12d. unsup   unsupervised GraphSAGE (UnsuperviseModel over two sage
              GNNNet towers, SageDataFlow([10, 10]), dims (128, 128), 20
              negatives, f32) on the graph of phase 5: both kernels
              against their plain versions, bit for bit and timed beside
              their bounds, at the step's shapes on its own frontiers
              and ids (the K=1 positive hop, the negatives tower's hops
              of 20,480 and 225,280 nodes, its 2,478,080-row feature
              gather); infer of 8192 ids
              with 7 fan_draw launches a batch (the positive hop, then 2
              hops in each of the 3 tower calls) and 3 gather_rows (one
              per tower call), two batches profiled; evaluate (mrr) of
              4096 roots; one step card vs CPU (equal positives,
              negatives and tower blocks, loss and gradients within 1e-4);
              8 train steps with 7 and 3 launches a step and the
              reservoir redraw, two profiled
 12e. loop    every family's train loop, f32, as NodeEstimator and
              EdgeEstimator.train run it with steps_per_loop = 5 (sage,
              gin, gat and the unsupervised head on the graph of phase 5,
              rgcn, gcn and transe on graphs of their own): 2 loops (a
              captured step replayed) against 10 eager steps from the
              same weights, seed and reservoir rows, the final loss and
              every parameter equal bit for bit (transe within rtol 1e-4,
              atol 1e-5: its Embed backward sums with index_add_ atomics);
              each kernel launched inside the replays equal to its plain
              version on the last replay's inputs; both runs' launch
              counts equal, and per step as in phases 10 and 12; two
              replays draw different batches; the replayed and the eager
              step timed (host clock); 4 loops of 5 replays profiled (the
              card's idle share), the launches a replay adds to the counts
              equal to an eager step's and the trace holding one event for
              each launch counted; one eager step under
              torch.cuda.set_sync_debug_mode("error"). Sage with a
              checkpoint every loop (2 kept) and RunConfig.profile: the
              checkpoints left, a fresh estimator restoring equal
              parameters at its first infer, the ProfilerHook's trace
              naming both kernels. Then sage, gin, gat, rgcn and gcn as
              phase 13's bench builds and loops them (bf16, 50 steps a
              loop, gcn's 20 over every node): 2 loops replayed against
              the same loops run eagerly, loss and parameters equal bit
              for bit and the counts equal, and one loop of replays
              profiled with the same trace check
 12f. convs   the eight convs of bench.CONV_MODES (tag, sgcn, agnn, appnp,
              graph, arma, dna, gated; bench.make_model, f32) at full
              width on the graph of phase 5, each: infer of 8192 ids (16
              + 16 launches); one step card vs CPU on 256 roots (sampled
              ids equal, loss and every gradient within 1e-4); phase 12e's loop
              checks (steps_per_loop = 5: 2 loops replayed against 10
              eager steps bit for bit, both kernels equal to their plain
              versions on the last replay's inputs, held 2 + 2 checked
              against a trace of replays, the replayed step's busy time,
              idle share and peak memory)
 12h. encoder sage at full width over ShallowEncoder(dense "feature", the id
              table of N + 1 rows, a "tags" sparse feature hashed into
              1000 rows; both tables 16 wide), "tags" an [N, 8] int32
              table drawn from a numpy seed (ids 0..9,999, -1 past random
              lengths 0-8), for the sum and the mean combiner: one step
              card vs CPU (within 1e-4) and the loop checks of 12e (the
              replayed loop within rtol 1e-4, atol 1e-5 of the eager
              steps: the tables' backward is an index_add_); then
              JKGNNNet("sage", concat) over it, one step card vs CPU
 12g. whole   the examples' whole-graph configurations, tag, sgcn, agnn,
              appnp and arma over WholeDataFlow(2, [(0,)]) at dims
              (128, 128), f32, on phase 12b's graph, each: the forward on
              the ELL pack against the edge list on the card (within
              1e-4); 2 train steps over every node (0 + 2 launches a
              step, WHOLE_ELL_AGG ell_agg and WHOLE_ELL_SDDMM ell_sddmm
              launches) with their time
              and peak memory, two more profiled, a loop of 2 steps
              replayed and timed; one step card vs CPU
              (loss and every gradient within 1e-4) on a 10,000-node
              graph of the same kind
 12i. walk    sage with dedup_features=True on the graph of phase 5: its
              embeddings on one batch equal the plain fetch's, and phase
              12e's loop checks (2 + 2 launches a step, each gather_rows
              launch inside a replay equal to its plain version). Then
              random_graph(200_000, 25, seed=0, packs=("group", "adj",
              "sample", "fan"), build_in_edges=True): check_bias_cap
              (node2vec's 64-neighbor windows truncate no node); the new
              verbs card vs CPU bit for bit (phase_verbs; the layer draw
              but for a near tie at its edge; the graph-label verbs on a
              labelled graph of 2,000 nodes); one step from the hub
              200,000 times, unbiased and node2vec's, against the hub's
              edge weights; then DeepWalk, Node2Vec (p 0.5, q 2, exact,
              windows of 64) and LINE of orders 1 and 2, 64 wide, walks of
              5 steps, windows 1 and 1, 8 negatives: one batch card vs
              CPU (walks equal but for near ties of node2vec's Gumbel
              keys, loss and gradients within 1e-4), evaluate (mrr) of
              4096 roots and infer of 8192 ids, neither launching a
              kernel, and phase 12e's loop checks with SGD and
              steps_per_loop 10 (replays bit for bit, 0 + 0 launches held
              against a trace, a profiled window of 20 replays)
 12j. rest    this slice's families, f32, Adam 1e-3: on random_graph(
              200_000, 25, feat_dim=128, n_classes=16, seed=0, packs=(
              "group", "adj", "sample", "fan")) at batch 1024 and dims
              (128, 128), adaptivegcn and fastgcn (GNNNet gcn over
              LayerwiseDataFlow / FastDataFlow([1024, 1024]), 8
              candidates a node), GAE, VGAE and DGI (gcn over
              SageDataFlow([10, 10]), 5 negatives), GeniePath ([10, 10])
              and LGCN ([6, 6], k 4) under SuperviseModel, ScalableSageNet
              (2 layers, fanout 10, mean, one [200,001, 128] store),
              SolutionModel (DenseLogits over sage [10, 10]) by
              NodeEstimator and by SampleEstimator over a [100,000, 1]
              table, SampleSolutionModel (two sage towers in GroupGNNNet,
              PosNegLogits, xent_loss); on motif_graph(188) gin ([5, 5],
              hidden 32, batch 32 graphs) with mean pooling and with
              set2set, by GraphEstimator. Each: one loop of 10 steps
              (the first eager, one captured and replayed) against 10
              eager steps, loss and state (the scalable store too) equal
              bit for bit (the pools sum in a fixed order), each kernel
              launch inside the replays
              equal to its plain version, the counts per step as
              REST_LAUNCHES; a loop of replays timed beside eager steps,
              one profiled (busy and idle time, held launches against the
              trace), peak memory; then one step card vs CPU on a
              10,000-node graph of the same kind (the motif graph for the
              graph families) from the same weights, batch and draws: loss
              and every gradient within 1e-4, the layer draws equal but
              for near ties of their Gumbel keys
 12k. data    the data plane at the main path's width: the graph of
              phase 5's shape (200,000 nodes typed "train" or "test",
              5,000,000 edges of one type, "feature" 128 and "label" 16,
              from a numpy seed) converted by graph.stream_convert's
              StreamWriter in chunks of at most 1M rows into 4
              partitions (seconds, traced host memory peak, part bytes),
              loaded back with packs=("fan",) and held against what was
              written (the edges as a multiset of (src, dst, weight), the
              node types and features by external id); one sage step
              (bench.make_model, f32, Adam 1e-3, batch 1024 of the train
              nodes) card vs CPU (ids, masks, weights and edge ids equal,
              loss within 1e-5, gradients within 1e-4) and through
              NodeEstimator.step with 2 + 2 launches, and its loop of 10
              (captured, replayed) against 10 eager steps bit for bit,
              one loop of replays profiled; the same step over a bf16
              feature table (load_graph(feature_dtype=torch.bfloat16));
              the same step and loop over packs=() (the fan-less
              fallback, 0 + 2 launches); one payload rgcn step
              (SageDataFlow(payload=True) over 4 relations,
              relation_from_etype) card vs CPU on a copy of the graph with
              4 relations and the "sample" pack (0 + 2 launches); then
              the example scripts run_graphsage, run_gcn and run_rgcn by
              their main(argv) on the SBM stand-in that the port converts
              under a temporary --data_dir, each train_and_evaluate of 20
              steps, and run_graphsage's infer from its checkpoint
 12l. query  the query path on the graph of phase 5 and its CPU copy:
              Query(g).v(1024 ids).sampleNB([0], 25).values("feature");
              sampleN(-1, 1024).gt("feature", 0.5) over the [N] mask and
              over an AttrIndex of feature:0; sampleE(-1, 4096).gt(
              "weight", 0.9) over the [E] mask; v(ids).outE([0], 64)
              .inV().values(udf_mean, udf_max of "feature") (one gather
              shared); v(ids).sampleNB([0], 25).order_by("weight",
              desc=True).limit(10); v(ids).sampleLNB([0], 8, 1024). Each
              on the card from a generator and on the CPU from the card's
              uniforms: ids, masks, weights, types and eids equal bit for
              bit, gathered features bit for bit, the UDFs within 1e-6,
              the layer by the near-tie rule (DrawReplay); the launches of
              each query (gather_rows 1 where it gathers, fan_draw none),
              each gather_rows launch equal to its plain version; ms per
              query (CUDA-event medians of QUERY_RUNS runs). Then the IVF
              index over the graph's [200,000, 128] feature table, nlist
              256: k-means on the card step by step against the CPU's
              Lloyd step from the same centroids (assignments equal but
              for points whose two nearest centroids lie within 1e-5
              relative, centroids within 1e-4 in the clusters no such
              point touched), the build's seconds and the k-means with
              and without the fixed-order sum; recall@10 of 1024 numpy
              queries against the exact KnnIndex at nprobe 8 and (256 of
              them) at nprobe 256, which must be 1.0 but for near ties;
              ms per 256 queries at nprobe 8; one search batch's
              gather_rows launch equal to its plain version
 12m. examples the 28 example scripts of this slice (TransX and its four
              model scripts, distmult, deepwalk, line, gat, agnn, appnp,
              arma, sgcn, tagcn, dna, adaptivegcn, fastgcn, gin, graphgcn,
              set2set, gated_graph, dgi, gae, geniepath, lgcn,
              scalable_sage, solution, sample_solution) by their
              main(argv) on their stand-ins under a temporary --data_dir,
              each train_and_evaluate of EXAMPLE_12M_STEPS steps on the
              card, with each script's launches
 12n. gat     the gat-train cell's whole-graph block
              (benchmark/configs/gat.json's graph, the gcn cell's) at its
              widths, 3 heads of 250, bf16: GAT's fused ell_gat,
              ell_gat_sddmm and ell_gat_tr and the weighted ell_sddmm
              held to their plain versions (GAT_TOL, ATTN_TOL) and timed
              beside their bytes bound
              (benchmark/harness/gat_arith.call_bytes) and the plain
              versions' time; with --parent the parent's three GAT
              kernels too, their outputs equal bit for bit and timed in
              turns (parent, change, change, parent); a 3-layer
              multi-head GAT loop at 3,000 nodes, its replays equal to
              its eager steps bit for bit, 9 ell_gat launches a step held
              by a replay
 12s. xent    SuperviseModel's loss kernels (ops.sigmoid_xent) at the
              rgcn-train cell's shape, [629,571, 349] f32 logits and
              one-hot labels: held to the torch chain they replace and
              to their plain versions (XENT_TOL), -g y at a logit of 0,
              the same bits on a second call, then timed beside their
              bytes bound and the chain's forward and backward
 13. bench    the port's bench (euler_tpu_torch/bench.py) in each mode,
              sage, gin, gat, rgcn, the eight of bench.CONV_MODES, gcn and
              transe, at bench.py's width,
              bf16 activations in the GNN modes (transe is f32): warmup,
              single_loop and pipelined JSON lines, each loop a TrainLoop
              (one captured step replayed); each kernel 2
              launches per step in the sampled modes, gather_rows 2 and
              fan_draw none in gcn, neither in transe
 14. mesh     sharded sage serving over torch.distributed on the graph
              of phase 5 and the model of phase 6 (f32): build_sharded
              into 4 shards and into 1 on the host, one file a shard
              under build/mesh14/; the one-card pack's rows checked equal
              to the shards' but for the reservoir rows (which each
              shard, and phase 10's redraws, draw on their own), which
              it takes from the one shard for the one-card forward of
              rank 0's 1024 roots, then from the 4 shards for the
              one-card forward of 4 x 1024 roots, each rank's from its
              own uniforms U_r. Then 4 gloo ranks spawned on the one
              card (data=1, graph=4), each loading only its shard: one
              make_sharded_apply of the whole batch with every owner
              reading U_all = cat(U_0..U_3), each rank's embeddings and
              logits equal to the one-card forward bit for bit, 2 + 2
              launches, each equal to its plain version; one batch's
              bytes and calls by collective and the gloo host copies
              (comms.account()); ms per batch (CUDA-event median of 20,
              40 + 40 launches); rank 0 profiles one batch (its trace
              holding the 4 launches), lists the host ops of another
              (self CPU time by op, beside the one-card forward's) and
              times each kernel at the shape it launched; each rank's
              seconds by stage. Then a one-rank NCCL group (data=1,
              graph=1) in this process over the one shard, held the
              same way against the one-card forward of rank 0's roots.
              A rank that fails or outlives the timeout fails the phase
 15. mesh train  training over the mesh on phase 14's shard files (f32,
              Adam 1e-3): the one-card sage step (a fresh model from seed
              15) over 4 x 1024 roots, 3 steps from per-hop uniforms drawn
              for the concatenated batch, on the 4 shards' reservoir rows,
              and over rank 0's 1024 roots on the one shard's; then 4 gloo
              ranks spawned on the one card (data=1, graph=4), each
              loading only its shard: 3 steps of make_sharded_train_step
              from the group's ids and each owner's uniforms (its group's
              rows of the one-card draws), each step's loss and the final
              parameters equal to the one-card steps' within 1e-4, the
              replicated parameters bit-equal across ranks, 2 + 2 launches
              a step, each equal to its plain version; one step's bytes by
              collective, forward and backward, gloo's host copies apart
              (comms.account()); ms per step (CUDA-event median of 10,
              20 + 20 launches); rank 0 profiles one step (idle share) and
              times each kernel at the shape it launched;
              SpmdNodeEstimator.train of 4 steps with a reservoir redraw
              (finite loss, 8 + 8 launches). In the same ranks, TransE
              (shard_embeddings) at phase 12c's width on its graph split
              in 4, 1024 triples a rank: one step's loss equal to the
              one-card dense model's over the 4096 triples with the
              negatives the ranks drew, the relation gradients equal and
              each entity block's gradient 4 times the one-card table's
              rows of it (the graph group's sum), each within 1e-4 of its
              largest, no kernel launch, and ms per step; gcn over psum
              blocks (WholeDataFlow, edge list) on random_graph(10_000,
              25), 256 roots a rank: one step's loss and gradients equal
              to the one-card step's over the 1024 roots within 1e-4 of
              their largest, 2 gather_rows launches, each equal to its
              plain version. Then a one-rank NCCL group in this process over the
              one shard, held the same way against the one-card steps of
              rank 0's roots
 16. tools    the repo's tools on the port (euler_tpu_torch/tools/):
              16a bench.run(model="sage", nodes=1_000_000) at bench.py's
              width, without and with dedup=True (bench.py's
              EULER_BENCH_NODES and EULER_BENCH_DEDUP): 2 + 2 launches a
              step (600 + 600 in its 300 steps), the captured step's four
              launches equal to their plain versions (fan_draw over the
              [1M, 128] fan pack, gather_rows from the [1M, 128] bf16
              table) and timed at their shapes (CUDA events, L2 flushed,
              with bounds and index_select); ms a step and edges/s; then
              gather_rows of 292,864 ids from [1M, 128] f32 and bf16
              tables, bit for bit, timed beside its bound, its plain
              version and index_select. 16b python -m
              euler_tpu_torch.tools.bench_suite --modes sage into
              build/tools16/: every mode a result, no error, the table.
              16c the scaling bench at 5,000 SBM nodes, 5 timed steps:
              1x1 over NCCL, then 1x2 and 1x4 over gloo ranks sharing the
              card with the 1x1 step as --chip-step-ms and phase 15's
              measured link as --link-gbs; on every rank its record, 2 +
              2 launches a step, one probed step's launches equal to
              their plain versions, and the forward bytes equal on the
              ranks of a shape. 16d the ingest drill at 10M edges, 1M
              nodes, 4 partitions, 4 gloo shards sharing the card, 3
              steps: every stage recorded, a finite DeepWalk loss, each
              rank's probed payload sage step with its gather_rows
              launches equal to their plain versions. 16e the parity
              harness on tests/test_datasets_raw.py's miniature cora
              fixture (--only _cora --steps 30: 15 rows ran, each with a
              delta) and gin_mutag, transe_fb15k (stand-ins,
              --allow-synthetic) and deepwalk_cora (--steps 5) on the
              card; no row an error
 17. entry    the driver's entry points (euler_tpu_torch/graft_entry.py,
              the counterpart of __graft_entry__.py) on the reference's
              small model (SBM, 256 nodes, feature 16, sage [5, 5], dims
              (32, 32)): entry()'s forward on the card, 2 + 2 launches,
              each equal to its plain version and timed at its shape,
              the loss and logit equal to the same forward on the CPU
              (the same weights, the card's uniforms) within 1e-4, ms a
              forward; then dryrun_multichip(1) on one NCCL rank and
              dryrun_multichip(4) on 4 gloo ranks sharing the card (mesh
              (1, 4)): on every rank the first sharded step's 2 + 2
              launches (4 + 4 in the loop of 2 steps, none in the
              DeepWalk step), one more probed step's launches equal to
              their plain versions, finite losses, the first step's
              bytes by collective equal on every rank, and
              comms.ppermute on the card (a cycle and, on 4 ranks, a
              partial permutation), forward and backward, equal bit for
              bit to the same permutation of the rows on the host; the
              losses, ms a step and bytes by collective logged
 18. report   one JSON line of kernels (the gather's f32 and bf16 times,
              also at gcn's shape, fan_draw's launch floor, its paths'
              crossover and its union shapes, each kernel's launches on
              every path, the mesh's shapes in serving and in a train
              step, the 1M-node bench's shapes, the entry forward's,
              ell_agg's times of 12b and ptxas figures), then the last
              line {"ok": true, "device": {...}}

Phases 12c, 12d, 12e, 12f, 12h, the dedup part of 12i, 12l, 14 and 15
run after 12 in that order, then the walk part of 12i, 12j, 12b, 12g,
12n, 12k, 12m, 13, 16 and 17.

It exits non-zero, with no result line, where torch.cuda.is_available()
is false or the euler_tpu_torch package is missing.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import copy
import ctypes
import dataclasses
import importlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import resource
import tempfile
import time
import types
import tracemalloc
import urllib.request

import numpy as np
import torch
import torch.distributed as dist

from euler_tpu_torch import bench, graft_entry, knn
from euler_tpu_torch._build import (NVCC_FLAGS, PACKAGE_DIR,
                                    build_shared_library, nvcc)
from euler_tpu_torch.dataflow import (FastDataFlow, LayerwiseDataFlow,
                                      SageDataFlow, WholeDataFlow)
from euler_tpu_torch.dataflow import block as block_lib
from euler_tpu_torch.datasets import motif_graph, random_graph
from euler_tpu_torch.datasets.synthetic import (MOTIF_CLASSES,
                                                MOTIF_FEATURE_DIM)
from euler_tpu_torch.estimator import (EdgeEstimator, GaeEstimator,
                                       GraphEstimator, NodeEstimator,
                                       RunConfig, SampleEstimator,
                                       SpmdNodeEstimator, TrainLoop,
                                       get_optimizer, make_graph_batch)
from euler_tpu_torch.examples.gcn import run_gcn
from euler_tpu_torch.examples.graphsage import run_graphsage
from euler_tpu_torch.examples.rgcn import run_rgcn
from euler_tpu_torch.graph import store
from euler_tpu_torch.graph.meta import FeatureSpec, GraphMeta
from euler_tpu_torch.graph.store import Graph, load_graph
from euler_tpu_torch.graph.stream_convert import StreamWriter
from euler_tpu_torch.models import (DGI, GAE, LINE, VGAE, DeepWalk,
                                    GeniePathLazyNet, GNNNet, GraphModel,
                                    GroupGNNNet, JKGNNNet, LGCNNet, Node2Vec,
                                    SampleSolutionModel, ScalableSageNet,
                                    SegmentPool, Set2SetPool, ShallowEncoder,
                                    SolutionModel, SuperviseModel,
                                    UnsuperviseModel, autoencoders, convs,
                                    encoders, kg)
from euler_tpu_torch.models import gnn as gnn_models
from euler_tpu_torch.native import loader as native
from euler_tpu_torch.ops import COUNTED
from euler_tpu_torch.ops import ell_agg as ell_ops
from euler_tpu_torch.ops import ell_attn as attn_ops
from euler_tpu_torch.ops import fan_draw as fd
from euler_tpu_torch.ops import feature_ops
from euler_tpu_torch.ops import index as index_ops
from euler_tpu_torch.ops import gather_rows as gr
from euler_tpu_torch.ops import rel_agg
from euler_tpu_torch.ops import sigmoid_xent as xent_ops
from euler_tpu_torch.ops import sampling, util_ops, walk
from euler_tpu_torch.ops.alias import (FAN_ALIAS_OFF, FAN_D, FAN_KEPT_OFF,
                                       FAN_PROB_OFF, FANU_MASK,
                                       FANU_MAX_TYPES, FANU_SHIFT)
from euler_tpu_torch.parallel import comms, sharded
from euler_tpu_torch.parallel import launch as launcher
from euler_tpu_torch.parallel import mesh as mesh_lib
from euler_tpu_torch.parallel import train as sharded_train
from euler_tpu_torch.query import EdgeResult, Query, udf_max, udf_mean
from euler_tpu_torch.serving import serve_embeddings
from euler_tpu_torch.tools import ingest_drill, parity_run, scaling_bench

# H100 SXM device-memory rate (NVIDIA data sheet), the bytes bound's divisor
HBM_BYTES_PER_S = 3.35e12
N_NODES, AVG_DEGREE, FEAT_DIM, N_CLASSES = 200_000, 25, 128, 16
FANOUTS, DIMS, BATCH, N_INFER = [25, 10], (128, 128), 1024, 8192
HOP_SHAPES = [(BATCH, FANOUTS[0]), (BATCH * (1 + FANOUTS[0]), FANOUTS[1])]
# bench.py's per-step edge count of the same two-hop sample (+ self loops)
EDGES_PER_BATCH = (BATCH * FANOUTS[0] + BATCH * FANOUTS[0] * FANOUTS[1]
                   + BATCH + BATCH * FANOUTS[0])
PARITY_TOL = dict(rtol=1e-4, atol=1e-4)
# the deepest gathered set: roots plus both hops' draws
GATHER_ROWS = BATCH * (1 + FANOUTS[0]) * (1 + FANOUTS[1])     # 292,864
TRAIN_STEPS, TRAIN_REFRESH = 8, 3
# the whole-graph gcn mode (bench.py's _gcn_child): every node a root, and
# the widths of random_graph(100_000, 25, seed=0)'s ELL pack
GCN_NODES = bench.GCN_SIZES["cuda"][0]
GCN_C, GCN_C_IN = 53, 49
# the ELL widths of the benchmark's gcn-train graph (C and C_in alike)
GCN_CELL_C = 36
# ell_agg launches a step of the bench's gcn (GCN_LAYERS convs): a forward
# aggregate a layer (all an inference batch makes), and a gradient to x in
# every layer but the first, whose x is the feature table
GCN_ELL_STEP = 2 * bench.GCN_LAYERS - 1
# bench.py's transe mode: its graph and batch, the ranking's triples and
# batch (trap: [batch, N, 100] f32 scores), the known triples of the
# filtered setting, the triples served
TRANSE_NODES, TRANSE_BATCH = bench.TRANSE_SIZES["cuda"][:2]
RANK_TRIPLES, RANK_BATCH, FILTER_TRIPLES = 64, 64, 100_000
KG_FAMILY = (kg.TransH, kg.TransR, kg.TransD, kg.DistMult)


def kernel_counts(fan_draw: int = 0, gather_rows: int = 0,
                  ell_agg: int = 0, ell_sddmm: int = 0,
                  ell_gat: int = 0, rel_mean: int = 0,
                  rel_mean_tr: int = 0, sigmoid_xent: int = 0) -> dict:
    """Launches of each kernel wrapper in ``ops.COUNTED``, by name, as
    ``read_counts`` gives them; a kernel not named launches none."""
    return dict(fan_draw=fan_draw, gather_rows=gather_rows, ell_agg=ell_agg,
                ell_sddmm=ell_sddmm, ell_gat=ell_gat, rel_mean=rel_mean,
                rel_mean_tr=rel_mean_tr, sigmoid_xent=sigmoid_xent)


# SuperviseModel's loss (ops.sigmoid_xent): its launches a training step
# (the forward and the backward) and a forward alone (a served batch)
HEAD_STEP, HEAD_BATCH = 2, 1
# a loss kernel against its plain version on the same inputs: the largest
# distance over the plain result's largest magnitude (the loss's f32 sums
# in another order; the card's expf and log1pf)
XENT_TOL = 1e-5


# a typed mean kernel's result against its plain version: the largest
# distance over the plain version's largest magnitude (f32 sums in
# another order)
RGCN_TOL = 1e-5

# an ell_agg result against its plain version on the same inputs: the
# largest distance as a share of the sum of magnitudes (``ell_agg_gap``).
# f32: the order of the sums alone; bf16: the plain version rounds three
# times (its batched product, x * w_l, their sum), the kernel once
ELL_AGG_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


def ell_agg_gap(out: torch.Tensor, args: tuple) -> float:
    """``out`` of ``ell_agg(*args)`` against ``ell_agg_plain(*args)``: the
    largest |out - plain| over the plain aggregate of |x| and |w|, which
    bounds every partial sum of the row."""
    x, index, w_s, w_l, C, transpose = args
    plain = ell_ops.ell_agg_plain(*args).float()
    mag = ell_ops.ell_agg_plain(x.abs(), index, w_s.abs(), w_l.abs(), C,
                                transpose).float()
    return float(((out.float() - plain).abs()
                  / mag.clamp_min(1e-30)).max())


def xent_gap(out: torch.Tensor, want: torch.Tensor) -> float:
    """A loss kernel's result against its plain version's: the largest
    |out - want| over the largest |want|."""
    want = want.float()
    return float((out.float().to(want.device) - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


# unsupervised GraphSAGE (examples/graphsage/run_graphsage.py's fanouts):
# a step embeds B roots, B positives and B * 20 negatives; it launches
# fan_draw for the positive hop and 2 hops in each of 3 tower calls, and
# gather_rows once per tower call
UNSUP_FANOUTS, UNSUP_NEGS = [10, 10], 20
UNSUP_ROOTS = BATCH * (2 + UNSUP_NEGS)
UNSUP_EDGES_PER_BATCH = UNSUP_ROOTS * (
    UNSUP_FANOUTS[0] * (2 + UNSUP_FANOUTS[1]) + 1)
UNSUP_LAUNCHES = kernel_counts(fan_draw=1 + 2 * 3, gather_rows=3)


def reset_counts() -> None:
    for k in COUNTED:
        k.launches = 0


def read_counts() -> dict:
    return {k.__name__: k.launches for k in COUNTED}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


# ---------------------------------------------------------------- phase 3 --

def synthetic_fan_pack(rng, G: int) -> np.ndarray:
    """[G, 128] fan rows: degree 0..FAN_D, reservoir rows (degree FAN_D,
    prob 1), and about 2% of rows with a zero weight sum."""
    packs = np.zeros((G, 128), np.int32)
    deg = rng.integers(0, FAN_D + 2, G)
    reservoir = deg == FAN_D + 1
    deg = np.minimum(deg, FAN_D).astype(np.int32)
    packs[:, 0] = deg
    wsum = (rng.random(G).astype(np.float32) + 0.1) * (deg > 0)
    wsum[rng.random(G) < 0.02] = 0.0
    packs[:, 1] = wsum.view(np.int32)
    prob = rng.random((G, FAN_D)).astype(np.float32)
    prob[reservoir] = 1.0
    packs[:, FAN_PROB_OFF:FAN_PROB_OFF + FAN_D] = prob.view(np.int32)
    packs[:, FAN_KEPT_OFF:FAN_ALIAS_OFF + FAN_D] = rng.integers(
        0, G, (G, 2 * FAN_D))
    return packs


def synthetic_union_pack(rng, G: int) -> np.ndarray:
    """[G, 128] union fan rows: the rows of ``synthetic_fan_pack`` whose
    id lanes pack (type << FANU_SHIFT) | id, with types 0..15 and ids up
    to FANU_MASK (the largest ones included)."""
    packs = synthetic_fan_pack(rng, G)
    ids = rng.integers(0, FANU_MASK + 1, (G, 2 * FAN_D))
    ids[rng.random(ids.shape) < 0.05] = FANU_MASK
    types = rng.integers(0, FANU_MAX_TYPES, (G, 2 * FAN_D))
    packs[:, FAN_KEPT_OFF:FAN_ALIAS_OFF + FAN_D] = (types << FANU_SHIFT) | ids
    return packs


def needed_bytes(fan_pack, nodes, u1, u2) -> int:
    """Bytes the draw must move for these inputs: u1, u2, nodes read once,
    ids and valid written once, and from the fan rows of live nodes each
    distinct 8-byte head and each distinct prob and id lane a valid draw
    selects."""
    B, C = u1.shape
    live = nodes >= 0
    rows = nodes[live].long()
    packs = fan_pack[rows]
    deg = packs[:, 0:1]
    wsum = packs[:, 1].view(torch.float32)
    slot = (u1[live] * deg.float()).int()
    slot = torch.minimum(slot.clamp_min(0), (deg - 1).clamp_min(0)).long()
    ok = ((deg > 0) & (wsum > 0)[:, None]).expand(slot.shape)
    prob = torch.gather(packs, 1, FAN_PROB_OFF + slot).view(torch.float32)
    id_lane = torch.where(u2[live] < prob, FAN_KEPT_OFF + slot,
                          FAN_ALIAS_OFF + slot)
    base = rows[:, None] * 128
    cells = torch.cat([(base + FAN_PROB_OFF + slot)[ok],
                       (base + id_lane)[ok]])
    return (B * C * (4 + 4 + 4 + 1) + B * 4
            + 8 * int(torch.unique(rows).numel())
            + 4 * int(torch.unique(cells).numel()))


def time_launches(fn, iters: int, flush: torch.Tensor) -> float:
    """Median ms of ``fn`` on the card over ``iters`` launches, each with
    a cold L2 (``flush`` is rewritten between launches). A sleep kernel
    first lets the host queue every launch ahead of the card, so the
    events time the card's work and not the host's."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)
    for start, end in ev:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def time_in_turns(fns: dict, iters: int, flush: torch.Tensor) -> dict:
    """Time each of ``fns`` (name -> launch) twice, in the order given and
    then reversed (parent, change, change, parent): name -> [ms, ms]."""
    out = {k: [] for k in fns}
    for k in list(fns) + list(reversed(fns)):
        out[k].append(time_launches(fns[k], iters, flush))
    return out


def checked(fn):
    """A ctypes kernel call as a launch for time_launches: raises if the
    launch returns a CUDA error."""
    def launch():
        rc = fn()
        if rc != 0:
            raise RuntimeError(f"kernel launch failed (CUDA error {rc})")
    return launch


def n_params(src: str, entry: str) -> int:
    """The number of parameters of ``extern "C" int entry(...)`` in the
    source file ``src``."""
    with open(src) as f:
        m = re.search(rf"int {entry}\(([^)]*)\)", f.read())
    return m.group(1).count(",") + 1


def load_parent(parent_dir: str) -> dict:
    """The parent commit's kernel libraries (fan_draw, gather_rows and
    GAT's three entries of ell_attn), built by nvcc with this checkout's
    flags from the sources under ``parent_dir`` (a copy of the parent's
    tree): entry name -> ctypes function, typed as the current ones up to
    the parent's number of parameters (``etpu_fan_draw`` had no ``types``
    and ``union_rows`` before they were added after ``valid``)."""
    fns = {}
    for name, mod, entries in (("fan_draw", fd, ("etpu_fan_draw",)),
                               ("gather_rows", gr, ("etpu_gather_rows",)),
                               ("ell_attn", attn_ops, GAT_ENTRIES)):
        src = os.path.join(parent_dir, "euler_tpu_torch", "csrc",
                           f"{name}.cu")
        lib = ctypes.CDLL(build_shared_library(
            src, f"parent_{name}", [nvcc()] + NVCC_FLAGS))
        for entry in entries:
            fn, ref = getattr(lib, entry), getattr(mod.build(), entry)
            fn.argtypes = ref.argtypes[:n_params(src, entry)]
            fn.restype = ref.restype
            fns[entry] = fn
    return fns


#: parameters of an ``etpu_fan_draw`` without types and union_rows
IDS_ONLY_FAN_PARAMS = 13


def fan_call(fn, fan_pack, nodes, et, n_et, u1, u2, ids, valid, *path,
             types=None, union=False):
    """A raw call of an ``etpu_fan_draw`` (this checkout's or the
    parent's), or of ``etpu_fan_draw_path`` with its path, into
    preallocated outputs (``types`` too, where given)."""
    B, C = u1.shape
    stream = torch.cuda.current_stream().cuda_stream
    epilogue = () if len(fn.argtypes) == IDS_ONLY_FAN_PARAMS else (
        None if types is None else types.data_ptr(), int(union))
    return checked(lambda: fn(
        fan_pack.data_ptr(), fan_pack.shape[0], nodes.data_ptr(), B, C, et,
        n_et, u1.data_ptr(), u2.data_ptr(), -1, ids.data_ptr(),
        valid.data_ptr(), *epilogue, stream, *path))


def phase_kernel(dev, parent=None):
    rng = np.random.default_rng(0)
    G = N_NODES
    fan_pack = torch.from_numpy(synthetic_fan_pack(rng, G)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    one = int(np.float32(1).view(np.int32))
    mine = fd.build().etpu_fan_draw_path
    entries = {"row": (mine, (1,)), "draw": (mine, (2,))}
    if parent is not None:
        entries = {"parent": (parent["etpu_fan_draw"], ()), **entries}
    shapes = []
    # (B, C, n_et, et): the two hop shapes first (timed), then a ragged B,
    # one draw, more draws than lanes, one row past a multiple of a block's
    # rows, and nodes whose rows lie past the pack (clamped)
    for B, C, n_et, et in [HOP_SHAPES[0] + (1, 0), HOP_SHAPES[1] + (1, 0),
                           (1021, 25, 1, 0), (1, 1, 1, 0), (333, 50, 1, 0),
                           (4097, 10, 1, 0), (1000, 10, 3, 1)]:
        high = G if n_et == 1 else G + 1000
        nodes_np = rng.integers(0, high, B).astype(np.int32)
        nodes_np[rng.random(B) < 0.03] = -1
        nodes = torch.from_numpy(nodes_np).to(dev)
        u1, u2 = sampling.draw_fan_uniforms(gen, B, C, dev)
        ids, valid = fd.fan_draw(fan_pack, nodes, et, n_et, u1, u2, -1)
        ref_ids, ref_valid = fd.fan_draw_plain(fan_pack, nodes, et, n_et,
                                               u1, u2, -1)
        # both paths of the kernel, whatever the size would choose (and the
        # parent's kernel), each into outputs of its own
        outs, launches = {}, {}
        for name, (fn, path) in entries.items():
            outs[name] = (torch.full_like(ids, 7), ~ref_valid)
            launches[name] = fan_call(fn, fan_pack, nodes, et, n_et, u1, u2,
                                      *outs[name], *path)
            launches[name]()
        torch.cuda.synchronize()
        for name, (got_ids, got_valid) in [("kernel", (ids, valid))] + list(
                outs.items()):
            check(torch.equal(got_ids, ref_ids)
                  and torch.equal(got_valid, ref_valid),
                  f"fan_draw {name} != plain at B={B} C={C} n_et={n_et}")
        err = int((ids.long() - ref_ids.long()).abs().max())
        row_idx = nodes.clamp_min(0).long() * n_et + et
        rows = fan_pack[row_idx.clamp_max(G - 1)]
        cover = dict(valid=int(valid.sum()),
                     node_minus1=int((nodes < 0).sum()),
                     clamped=int((row_idx >= G).sum()),
                     deg0=int((rows[:, 0] == 0).sum()),
                     reservoir=int(((rows[:, 0] == FAN_D)
                                    & (rows[:, FAN_PROB_OFF] == one)).sum()))
        row = dict(B=B, C=C, n_et=n_et, et=et, bit_exact=True,
                   max_abs_err=err, cover=cover)
        if (B, C) in HOP_SHAPES and n_et == 1:
            row["ms"] = time_launches(
                lambda: fd.fan_draw(fan_pack, nodes, 0, 1, u1, u2, -1), 200,
                flush)
            row["plain_ms"] = time_launches(
                lambda: fd.fan_draw_plain(fan_pack, nodes, 0, 1, u1, u2, -1),
                50, flush)
            nbytes = needed_bytes(fan_pack, nodes, u1, u2)
            row.update(bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
            row["turns_ms"] = time_in_turns(launches, 200, flush)
        shapes.append(row)
        log(f"kernel: {json.dumps(row)}")
    # the crossover of the two paths: both, bit-exact, timed in turns
    # (row, draw, draw, row) at sizes between and around the two hops
    paths = {k: v for k, v in entries.items() if k != "parent"}
    crossover = []
    for B in (1024, 2048, 4096, 8192, 12_800, 26_624):
        for C in (10, 15, 20, 25):
            nodes = torch.randint(0, G, (B,), generator=gen,
                                  dtype=torch.int32, device=dev)
            u1, u2 = sampling.draw_fan_uniforms(gen, B, C, dev)
            ref_ids, ref_valid = fd.fan_draw_plain(fan_pack, nodes, 0, 1,
                                                   u1, u2, -1)
            launches = {}
            for name, (fn, path) in paths.items():
                ids, valid = torch.full_like(ref_ids, 7), ~ref_valid
                launches[name] = fan_call(fn, fan_pack, nodes, 0, 1, u1, u2,
                                          ids, valid, *path)
                launches[name]()
                torch.cuda.synchronize()
                check(torch.equal(ids, ref_ids)
                      and torch.equal(valid, ref_valid),
                      f"fan_draw {name} != plain at B={B} C={C}")
            crossover.append(dict(B=B, C=C, **time_in_turns(launches, 200,
                                                             flush)))
            log(f"kernel: paths {json.dumps(crossover[-1])}")
    # an empty launch timed the same way: the floor under hop 1
    floor_ms = time_launches(lambda: torch.cuda._sleep(0), 200, flush)
    log(f"kernel: launch_floor_ms {floor_ms}")
    return shapes, crossover, floor_ms


def phase_union(dev):
    """The typed and union epilogue of fan_draw against the plain version,
    bit for bit (ids, valid and types), from the wrapper and from each
    path, at both hop shapes: union rows (types 0..15, ids up to
    FANU_MASK) with and without types, and the one-type typed output on
    a 2-type pack whose rows past the pack clamp. Then the union draw
    (with types) timed in turns with the untyped draw over rows of the
    same degrees: untyped, union, union, untyped."""
    rng = np.random.default_rng(2)
    G = N_NODES
    union_pack = torch.from_numpy(synthetic_union_pack(rng, G)).to(dev)
    fan_pack = torch.from_numpy(synthetic_fan_pack(rng, G)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    mine = fd.build()
    rows = []
    for B, C in HOP_SHAPES:
        nodes_np = rng.integers(0, G, B).astype(np.int32)
        nodes_np[rng.random(B) < 0.03] = -1
        nodes = torch.from_numpy(nodes_np).to(dev)
        u1, u2 = sampling.draw_fan_uniforms(gen, B, C, dev)
        # name -> (pack, et, n_et, union, nodes); the typed case's nodes
        # reach G // 2 + 99, so rows 2 * node + 1 past the pack clamp
        cases = {"union": (union_pack, 0, 1, True, nodes),
                 "typed": (fan_pack, 1, 2, False, torch.where(
                     nodes < 0, nodes, nodes % (G // 2 + 100)))}
        row = dict(B=B, C=C, bit_exact=True)
        for name, (pack, et, n_et, union, nd) in cases.items():
            want = fd.fan_draw_plain(pack, nd, et, n_et, u1, u2, -1, union,
                                     True)
            got = {"wrapper": fd.fan_draw(pack, nd, et, n_et, u1, u2, -1,
                                          union, True)}
            ids_only = fd.fan_draw(pack, nd, et, n_et, u1, u2, -1, union)
            for path in (1, 2):
                out = (torch.full_like(want[0], 7), ~want[1],
                       torch.full_like(want[2], 7))
                fan_call(mine.etpu_fan_draw_path, pack, nd, et, n_et, u1, u2,
                         out[0], out[1], path, types=out[2], union=union)()
                got[f"path {path}"] = out
            torch.cuda.synchronize()
            for how, g in got.items():
                check(all(torch.equal(a, b) for a, b in zip(g, want)),
                      f"fan_draw {name} {how} != plain at B={B} C={C}")
            check(torch.equal(ids_only[0], want[0])
                  and torch.equal(ids_only[1], want[1]),
                  f"fan_draw {name} without types != plain at B={B} C={C}")
            ids, valid, types = want
            row[name] = dict(
                valid=int(valid.sum()), node_minus1=int((nd < 0).sum()),
                max_id=int(ids.max()),
                types=sorted(int(t) for t in torch.unique(types)),
                max_abs_err=int((got["wrapper"][0].long()
                                 - ids.long()).abs().max()))
        check(row["union"]["types"] == [-1] + list(range(FANU_MAX_TYPES)),
              f"union types at B={B}: {row['union']['types']}")
        # times: the wrapper's union draw and its plain version, then the
        # raw untyped and union draws in turns into preallocated outputs
        row["ms"] = time_launches(
            lambda: fd.fan_draw(union_pack, nodes, 0, 1, u1, u2, -1, True,
                                True), 200, flush)
        row["plain_ms"] = time_launches(
            lambda: fd.fan_draw_plain(union_pack, nodes, 0, 1, u1, u2, -1,
                                      True, True), 50, flush)
        nbytes = needed_bytes(union_pack, nodes, u1, u2) + 4 * B * C
        row.update(bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        outs = [(torch.empty((B, C), dtype=torch.int32, device=dev),
                 torch.empty((B, C), dtype=torch.bool, device=dev))
                for _ in range(2)]
        types = torch.empty((B, C), dtype=torch.int32, device=dev)
        row["turns_ms"] = time_in_turns({
            "untyped": fan_call(mine.etpu_fan_draw, fan_pack, nodes, 0, 1,
                                u1, u2, *outs[0]),
            "union": fan_call(mine.etpu_fan_draw, union_pack, nodes, 0, 1,
                              u1, u2, *outs[1], types=types, union=True)},
            200, flush)
        rows.append(row)
        log(f"kernel: union {json.dumps(row)}")
    return rows


# ---------------------------------------------------------------- phase 4 --

def int_view(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32 if x.element_size() == 4 else torch.int16)


def gather_ids(rng, M: int, N: int, dev, kind: str = "mixed"):
    """int32 ids [M]. "mixed": uniform in [0, N) with about 1% of -1 and
    a few >= N (one of each at the front); "minus1": all -1; "beyond": all
    >= N; "repeat": eight rows, over and over; "arange": 0 .. M-1 (the
    whole-graph feature and label gathers)."""
    if kind == "arange":
        ids = np.arange(M, dtype=np.int32)
    elif kind == "minus1":
        ids = np.full(M, -1, np.int32)
    elif kind == "beyond":
        ids = (N + rng.integers(0, 7, M)).astype(np.int32)
    elif kind == "repeat":
        ids = rng.integers(0, 8, M).astype(np.int32)
    else:
        ids = rng.integers(0, N, M).astype(np.int32)
        ids[rng.random(M) < 0.01] = -1
        ids[rng.random(M) < 0.001] = N + rng.integers(0, 7)
        ids[:3] = [-1, N, N - 1][:M]
    return torch.from_numpy(ids).to(dev)


def gather_bytes(table, ids) -> int:
    """Bytes the gather must move: each distinct in-range row read once,
    the output written once, the ids read once."""
    N, D = table.shape
    ok = ids[(ids >= 0) & (ids < N)]
    rows = int(torch.unique(ok).numel())
    elt = table.element_size()
    return rows * D * elt + ids.numel() * D * elt + 4 * ids.numel()


def gather_call(fn, table, ids, out):
    """A raw call of an ``etpu_gather_rows`` (this checkout's or the
    parent's) into ``out`` [M, D]."""
    (N, D), M = table.shape, ids.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    return checked(lambda: fn(
        table.data_ptr(), N, D, table.element_size(), ids.data_ptr(), M,
        out.data_ptr(), D, 0, stream))


def phase_gather(dev, parent=None):
    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev).manual_seed(7)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    f32, bf16 = torch.float32, torch.bfloat16
    # (N, D, M, dtype, out width or None, col_offset, ids, timed): timed
    # "sampled" at the deepest hop's shape, "gcn" at the whole graph's
    cases = [
        (N_NODES, FEAT_DIM, GATHER_ROWS, f32, None, 0, "mixed", "sampled"),
        (N_NODES, FEAT_DIM, GATHER_ROWS, bf16, None, 0, "mixed", "sampled"),
        (GCN_NODES, FEAT_DIM, GCN_NODES, f32, None, 0, "arange", "gcn"),
        (GCN_NODES, FEAT_DIM, GCN_NODES, bf16, None, 0, "arange", "gcn"),
        (GCN_NODES, N_CLASSES, GCN_NODES, f32, None, 0, "arange", None),
        (N_NODES, N_CLASSES, BATCH, f32, None, 0, "mixed", None),
        (N_NODES, N_CLASSES, BATCH, bf16, None, 0, "mixed", None),
        (5000, 1, 10_007, f32, None, 0, "mixed", None),
        (5000, 3, 10_007, f32, None, 0, "mixed", None),
        (5000, 127, 10_007, f32, None, 0, "mixed", None),
        (5000, 5, 10_007, bf16, None, 0, "mixed", None),
        (5000, 128, 10_007, f32, 256, 128, "mixed", None),  # 16-byte path
        (5000, 128, 10_007, bf16, 264, 8, "mixed", None),   # 16-byte path
        (5000, 64, 10_007, f32, 300, 37, "mixed", None),    # element path
        (5000, 128, 1, f32, None, 0, "mixed", None),
        (5000, 128, 33, f32, None, 0, "mixed", None),       # past a tile
        (5000, 128, 1000, f32, None, 0, "mixed", None),     # ragged stage
        (5000, 128, 1000, bf16, 200, 64, "mixed", None),
        (5000, 128, 4099, f32, None, 0, "minus1", None),
        (5000, 128, 4099, bf16, None, 0, "beyond", None),
        (5000, 128, 4099, f32, 256, 0, "beyond", None),
        (5000, 128, 65_536, f32, None, 0, "repeat", None),
    ]
    rows = []
    for N, D, M, dtype, W, off, kind, timed in cases:
        table = torch.randn((N, D), generator=gen, device=dev, dtype=dtype)
        ids = gather_ids(rng, M, N, dev, kind)
        if W is None:
            got = gr.gather_rows(table, ids)
            want = gr.gather_rows_plain(table, ids)
        else:
            base = torch.full((M, W), 7.0, dtype=dtype, device=dev)
            got = gr.gather_rows(table, ids, base.clone(), off)
            want = gr.gather_rows_plain(table, ids, base.clone(), off)
        torch.cuda.synchronize()
        what = f"N={N} D={D} M={M} {dtype} W={W} offset={off} ids={kind}"
        check(got.dtype == want.dtype and got.shape == want.shape
              and torch.equal(int_view(got), int_view(want)),
              f"gather_rows kernel != plain at {what}")
        err = float((got.float() - want.float()).abs().nan_to_num(0).max())
        row = dict(N=N, D=D, M=M, dtype=str(dtype).replace("torch.", ""),
                   out_width=W, col_offset=off, ids=kind, bit_exact=True,
                   max_abs_err=err,
                   nan_rows=int(torch.isnan(got).any(1).sum()),
                   zero_rows=int((ids < 0).sum()))
        check(row["nan_rows"] == int((ids >= N).sum()),
              f"NaN rows exactly where ids >= N at {what}")
        if timed:
            row["timed"] = timed
            out = torch.empty((M, D), dtype=dtype, device=dev)
            clamped = ids.clamp(0, N - 1)
            row["ms"] = time_launches(
                lambda: gr.gather_rows(table, ids, out), 200, flush)
            row["plain_ms"] = time_launches(
                lambda: gr.gather_rows_plain(table, ids), 50, flush)
            row["library_ms"] = time_launches(
                lambda: torch.index_select(table, 0, clamped), 200, flush)
            # a yardstick of the card's streaming rate: copying [M, D]
            # reads and writes M * D elements once each, in order
            dense = torch.empty_like(out)
            row["copy_ms"] = time_launches(lambda: out.copy_(dense), 200,
                                           flush)
            row["bytes"] = gather_bytes(table, ids)
            row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
            row["distinct_rows"] = int(torch.unique(
                ids[(ids >= 0) & (ids < N)]).numel())
        if timed == "sampled":
            # what the ids' order and repeats cost: the same ids sorted
            # (repeats adjacent, rows in order), and M ids with no repeat
            # in random order from a table of 2N rows, each bit-exact
            wide = torch.empty((2 * N, D), dtype=dtype, device=dev)
            distinct = torch.randperm(2 * N, generator=gen,
                                      device=dev)[:M].int()
            for key, t, i in (("sorted", table, ids.sort().values),
                              ("distinct", wide, distinct)):
                check(torch.equal(int_view(gr.gather_rows(t, i, out)),
                                  int_view(gr.gather_rows_plain(t, i))),
                      f"gather_rows != plain on {key} ids at {what}")
                row[f"{key}_ms"] = time_launches(
                    lambda t=t, i=i: gr.gather_rows(t, i, out), 200, flush)
            row["distinct_bound_ms"] = (gather_bytes(wide, distinct)
                                        / HBM_BYTES_PER_S * 1e3)
            del wide
            if parent is not None:
                # the parent's kernel, bit-exact, and this checkout's in
                # turns
                launches = {
                    "parent": gather_call(parent["etpu_gather_rows"], table,
                                          ids, out),
                    "kernel": gather_call(gr.build().etpu_gather_rows, table,
                                          ids, out)}
                for name, launch in launches.items():
                    out.fill_(7.0)
                    launch()
                    torch.cuda.synchronize()
                    check(torch.equal(int_view(out), int_view(want)),
                          f"gather_rows {name} != plain at {what}")
                row["turns_ms"] = time_in_turns(launches, 200, flush)
        rows.append(row)
        log(f"gather: {json.dumps(row)}")
    return rows


# ---------------------------------------------------------------- phase 7 --

def eager_infer(est, ids) -> np.ndarray:
    """``est.infer(ids)``'s answer from the eager forward: each padded
    batch through the model with a fresh generator seeded as ``infer``
    seeds its own, no batch captured or replayed."""
    est.model.eval()
    with torch.no_grad():
        outs, n = est._batched_apply(
            np.asarray(ids, np.int32),
            lambda g, b, gen: est.model(g, b, generator=gen)["embedding"])
        return torch.cat(outs)[:n].cpu().numpy()


def record_draws(model) -> tuple:
    """(list, remove): a forward hook on the first conv of ``model``'s
    ``embedder`` appends a copy of its block's ``n_id`` (the deepest
    hop's draws) at each call; no hook where the model has none."""
    convs = getattr(getattr(model, "embedder", None), "convs", None)
    draws = []
    if not convs:
        return draws, lambda: None

    def hook(mod, args, out):
        n_id = getattr(args[1], "n_id", None)
        if n_id is not None:
            draws.append(n_id.clone())
    return draws, convs[0].register_forward_hook(hook).remove


def phase_infer(model, graph, out_dir, dev, want=None,
                edges_per_batch: int = EDGES_PER_BATCH):
    """``want``: the launch counts of infer (default: 2 fan_draw and 2
    gather_rows a batch and the loss's one); ``edges_per_batch``: the
    edges one forward aggregates. The
    infer call's first batch is eager, its second captured and the rest
    replayed (``infer_replays`` of 8); its answer and draws are held to
    the eager forward's."""
    roots0 = torch.arange(BATCH, dtype=torch.int32, device=dev)
    with torch.no_grad():                         # warm-up, not counted
        model(graph.tensors, roots0,
              generator=torch.Generator(device=dev).manual_seed(9))
    torch.cuda.synchronize()

    est = NodeEstimator(model, graph, RunConfig(batch_size=BATCH, seed=0),
                        device=dev)
    draws, remove = record_draws(model)
    reset_counts()
    t0 = time.perf_counter()
    emb = est.infer(np.arange(N_INFER), out_dir=out_dir)
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    launches = read_counts()
    want = want or kernel_counts(fan_draw=2 * N_INFER // BATCH,
                        gather_rows=2 * N_INFER // BATCH,
                        sigmoid_xent=HEAD_BATCH * N_INFER // BATCH)
    check(launches == want, f"launches in infer {launches}, want {want}")
    check(emb.shape == (N_INFER, DIMS[-1]), f"embedding shape {emb.shape}")
    check(bool(np.isfinite(emb).all()), "embeddings finite")
    check(est.infer_replays == N_INFER // BATCH - 1
          and est.infer_captures == 1,
          f"infer replayed {est.infer_replays} of {N_INFER // BATCH} "
          f"batches, captured {est.infer_captures} times")
    graphed_draws, draws[:] = list(draws), []
    eager = eager_infer(est, np.arange(N_INFER))
    remove()
    check(len(graphed_draws) == len(draws)
          and all(torch.equal(a, b) for a, b in zip(graphed_draws, draws)),
          "the graphed infer's draws equal the eager forward's")
    gap = float(np.abs(emb - eager).max() / max(np.abs(eager).max(), 1e-30))
    check(gap <= 1e-4, f"the graphed infer's answer is {gap} from the "
                       f"eager forward's")

    gen = torch.Generator(device=dev).manual_seed(3)
    batches = [torch.arange(i, i + BATCH, dtype=torch.int32, device=dev)
               for i in range(0, N_INFER, BATCH)]
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in batches:
            model(graph.tensors, r, generator=gen)
        torch.cuda.synchronize()
        fwd_s = (time.perf_counter() - t0) / len(batches)
    return emb, dict(
        launches=launches, infer_ms_per_batch=infer_s / len(batches) * 1e3,
        infer_replays=est.infer_replays, graphed_vs_eager=gap,
        forward_ms_per_batch=fwd_s * 1e3,
        infer_edges_per_sec=edges_per_batch / fwd_s)


# a trace can lose the first of its kernel events, from one to a few
# hundred: PAD_LAUNCHES fills of an int16 scalar (a kernel the port never
# runs) open each profiled window and take that loss
PAD_LAUNCHES = 2000
PAD_KERNEL = "FillFunctor<short>"


def profile(fn, what: str, attempts: int = 3) -> dict:
    """Log torch.profiler's table of CUDA time by kernel over ``fn()``,
    then one JSON line: the host-clock time of the window, the device's
    busy time (the sum of its kernels and copies; user annotations, which
    are spans, left out), its idle share of the window, and the kernels
    with the most device time. A trace can lose kernels: the window is
    taken again (up to ``attempts`` times) until it holds one event for
    each launch of the two kernels, as their counts give them, and
    ``kernel_events_complete`` says whether it did (``traced`` and
    ``launched`` give both counts). PAD_LAUNCHES fills open the window
    before ``fn`` runs; their events are left out of every figure but
    ``pad_traced``, the number the trace kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    pad = torch.empty(1, dtype=torch.int16, device="cuda")
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        before = read_counts()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD_LAUNCHES):
                pad.fill_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        launched = {k: n - before[k] for k, n in read_counts().items()}
        by_name, pad_traced = {}, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not getattr(
                    e, "is_user_annotation", False):
                if PAD_KERNEL in e.name:
                    pad_traced += 1
                    continue
                us, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        traced = {k: sum(n for name, (_, n) in by_name.items() if k in name)
                  for k in launched}
        if traced == launched:
            break
        log(f"profile ({what}): the trace holds {traced} of the launches "
            f"{launched}" + ("; again" if attempt < attempts else ""))
    log(f"profile ({what}), by CUDA time (the {PAD_KERNEL} fills open "
        f"the window):")
    log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20))
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    check(busy_ms > 0, f"the profile of {what} saw no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    out = dict(what=what, host_ms=host_ms, device_busy_ms=busy_ms,
               device_idle_share=1.0 - busy_ms / host_ms,
               kernel_events_complete=traced == launched, traced=traced,
               launched=launched, pad_traced=pad_traced, attempts=attempt,
               kernels=[dict(name=k[:90], us=us, calls=n)
                        for k, (us, n) in top])
    log(f"profile: {json.dumps(out)}")
    return out


def host_ops(fn, what: str, top: int = 15) -> dict:
    """torch.profiler's host side of one ``fn()``: the window's host-clock
    time, the self CPU time of every op together, and the ``top`` ops by
    self CPU time (CUDA runtime calls included) with their calls. No
    fills open this window, so no device figure is read from it."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    out = dict(what=what, host_ms=host_ms,
               self_cpu_ms=sum(e.self_cpu_time_total for e in ops) / 1e3,
               ops=[dict(name=e.key[:70], self_cpu_us=e.self_cpu_time_total,
                         calls=e.count) for e in ops[:top]])
    log(f"host ops: {json.dumps(out)}")
    return out


def phase_profile(model, graph, dev):
    gen = torch.Generator(device=dev).manual_seed(4)
    roots = torch.arange(BATCH, dtype=torch.int32, device=dev)

    def two_batches():
        with torch.no_grad():
            for _ in range(2):
                model(graph.tensors, roots, generator=gen)
    return profile(two_batches, "2 inference batches")


# ---------------------------------------------------------------- phase 8 --

def hop_uniforms(flow, g, roots, gen) -> list:
    """One uniforms tuple per hop of ``flow`` from ``roots``, as the flow
    draws them."""
    return flow.draw_uniforms(g, roots, gen)


def same_blocks(flow, g, roots, uniforms, g_cpu, u_cpu) -> list:
    """Sample ``roots`` on the card and on the CPU from the same uniforms
    and check equal ids, masks, edge weights, edge ids and edge types;
    returns the card's blocks."""
    blocks = flow(g, roots, uniforms=uniforms)
    blocks_cpu = flow(g_cpu, roots.cpu(), uniforms=u_cpu)
    for i, (bk, bc) in enumerate(zip(blocks, blocks_cpu)):
        check(torch.equal(bk.n_id.cpu(), bc.n_id)
              and torch.equal(bk.mask.cpu(), bc.mask)
              and torch.equal(bk.edge_weight.cpu(), bc.edge_weight)
              and torch.equal(bk.e_id.cpu(), bc.e_id),
              f"block {i}: sampled ids card != CPU")
        check((bk.e_type is None) == (bc.e_type is None)
              and (bk.e_type is None
                   or torch.equal(bk.e_type.cpu(), bc.e_type)),
              f"block {i}: sampled edge types card != CPU")
    return blocks


def phase_parity(model, graph, dev):
    roots = torch.arange(N_NODES // 2, N_NODES // 2 + BATCH,
                         dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    flow = model.embedder.flow
    uniforms = hop_uniforms(flow, graph.tensors, roots, gen)
    cpu = torch.device("cpu")
    g_cpu = graph.tensors.to(cpu)
    model_cpu = copy.deepcopy(model).to(cpu)
    u_cpu = [tuple(u.cpu() for u in hop) for hop in uniforms]
    with torch.no_grad():
        blocks = same_blocks(flow, graph.tensors, roots, uniforms, g_cpu,
                             u_cpu)
        emb = model(graph.tensors, roots, uniforms=uniforms)["embedding"]
        emb_cpu = model_cpu(g_cpu, roots.cpu(), uniforms=u_cpu)["embedding"]
    torch.cuda.synchronize()
    diff = float((emb.cpu() - emb_cpu).abs().max())
    check(torch.allclose(emb.cpu(), emb_cpu, **PARITY_TOL),
          f"embeddings card vs CPU: max abs diff {diff}")
    return dict(sampled_ids_equal=True, embedding_max_abs_diff=diff,
                n_id_sizes=[int(b.n_id.numel()) for b in blocks])


# ---------------------------------------------------------------- phase 9 --

def _request(port, path, obj=None):
    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def phase_serve(out_dir):
    saved = np.load(f"{out_dir}/embedding_0.npy")
    srv = serve_embeddings(out_dir, port=0, background=True)
    try:
        port = srv.server_port
        h = _request(port, "/healthz")
        check(h == {"status": "ok", "n": N_INFER, "d": DIMS[-1]},
              f"/healthz {h}")
        ids = [0, 17, N_INFER // 2 - 1, N_INFER - 1]
        got = np.asarray(_request(port, "/embedding", {"ids": ids})
                         ["embeddings"], np.float32)
        check(np.array_equal(got, saved[ids]), "/embedding rows == saved")
        near = _request(port, "/knn", {"id": 17, "k": 5})
        tol = 1e-3 * max(1.0, float((saved[17] ** 2).sum()))
        check(near["ids"][0] == 17 and abs(near["scores"][0]) <= tol,
              f"/knn by id {near}")
        q = saved[N_INFER // 2 - 1] + 0.01
        vec = _request(port, "/knn", {"vector": q.tolist(), "k": 8})
        check(len(vec["ids"]) == 8 and len(vec["scores"]) == 8
              and all(0 <= i < N_INFER for i in vec["ids"]),
              f"/knn by vector {vec}")
        return dict(healthz=h, knn_self_distance=near["scores"][0],
                    knn_vector_top=vec["ids"][0])
    finally:
        srv.shutdown()
        srv.server_close()


# --------------------------------------------------------------- phase 10 --

def redrawn_pack(g) -> str:
    """The pack whose reservoir rows a training run redraws and
    check_redraw reads: "fan", or "fanu" for a graph built with the union
    rows only."""
    return "fan" if g.fan_pack is not None else "fanu"


def check_redraw(before, g, rng, pack: str = "fan") -> dict:
    """The reservoir redraws rewrote only the kept and alias lanes of the
    rows in ``<pack>_over_rows`` of ``<pack>_pack``, with neighbors of
    each row's group (for "fanu": packed (type << 27) | dst lanes of the
    node's union group)."""
    after = getattr(g, f"{pack}_pack")
    over = getattr(g, f"{pack}_over_rows").long()
    keep = torch.ones(after.shape[0], dtype=torch.bool, device=after.device)
    keep[over] = False
    check(torch.equal(after[keep], before[keep]),
          "redraw changed a row that is not a reservoir row")
    check(torch.equal(after[over, :FAN_KEPT_OFF], before[over, :FAN_KEPT_OFF]),
          "redraw changed a head or prob lane")
    kept = after[over, FAN_KEPT_OFF:FAN_KEPT_OFF + FAN_D]
    check(torch.equal(kept, after[over, FAN_ALIAS_OFF:FAN_ALIAS_OFF + FAN_D]),
          "kept and alias lanes differ after the redraw")
    changed = (kept != before[over, FAN_KEPT_OFF:FAN_KEPT_OFF + FAN_D])
    check(bool(changed.any()), "the redraw changed nothing")
    ptr, dst = ((g.group_ptr, g.adj_dst) if pack == "fan"
                else (g.fanu_ptr, g.fanu_dst))
    gp, dst = ptr.cpu().numpy(), dst.cpu().numpy()
    rows, kept_np = over.cpu().numpy(), kept.cpu().numpy()
    for i in rng.choice(len(rows), min(500, len(rows)), replace=False):
        r = rows[i]
        check(set(kept_np[i]) <= set(dst[gp[r]:gp[r + 1]]),
              f"redrawn row {r} holds a non-neighbor")
    return dict(redrawn_pack=pack, reservoir_rows=len(rows),
                lanes_changed=float(changed.float().mean()))


def phase_train(model, graph, dev, seed: int = 0, per_step=None):
    """``seed`` seeds the run's draws: a run on a graph whose reservoir
    an earlier run redrew needs another, or its redraws repeat the
    earlier run's and change nothing. ``per_step``: each kernel's
    launches a step (default: 2 fan_draw, 2 gather_rows and the loss's
    2)."""
    cfg = RunConfig(batch_size=BATCH, total_steps=TRAIN_STEPS,
                    optimizer="adam", learning_rate=1e-3,
                    log_steps=TRAIN_STEPS, reservoir_refresh=TRAIN_REFRESH,
                    seed=seed)
    est = NodeEstimator(model, graph, cfg, device=dev)
    roots = []
    draw = est.train_batch
    est.train_batch = lambda g, gen: roots.append(draw(g, gen)) or roots[-1]
    pack = redrawn_pack(graph.tensors)
    before = getattr(graph.tensors, f"{pack}_pack").clone()

    reset_counts()
    t0 = time.perf_counter()
    res = est.train(log_fn=log)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_counts()
    per_step = per_step or kernel_counts(fan_draw=2, gather_rows=2,
                                         sigmoid_xent=HEAD_STEP)
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    check(launches == want, f"launches in train {launches}, want {want}")
    check(bool(np.isfinite(res["loss"])), f"train loss {res['loss']}")
    r = torch.stack(roots)
    check(r.shape == (TRAIN_STEPS, BATCH) and int(r.min()) >= 0
          and int(r.max()) < N_NODES, "roots in [0, N)")
    redraw = check_redraw(before, graph.tensors, np.random.default_rng(0),
                          pack)

    opt = torch.optim.Adam(model.parameters(), 1e-3)
    gen = torch.Generator(device=dev).manual_seed(6)
    prof = profile(lambda: [est.step(opt, est.train_batch(graph.tensors, gen),
                                     generator=gen) for _ in range(2)],
                   "2 train steps")
    return dict(launches=launches, profile_host_ms=prof["host_ms"],
                profile_device_busy_ms=prof["device_busy_ms"],
                profile_complete=prof["kernel_events_complete"],
                loss=res["loss"],
                train_ms_per_step=train_s / TRAIN_STEPS * 1e3,
                distinct_roots=int(torch.unique(r).numel()), **redraw)


# --------------------------------------------------------------- phase 11 --

def phase_grads(model, graph, dev, g_cpu=None):
    """``g_cpu``: the graph's tensors moved to the CPU (made here where
    not given); its reservoir rows are first set to the card's, which a
    train run since may have redrawn."""
    gen = torch.Generator(device=dev).manual_seed(8)
    roots = sampling.sample_node(graph.tensors, BATCH, -1, gen)
    flow = model.embedder.flow
    uniforms = hop_uniforms(flow, graph.tensors, roots, gen)
    cpu = torch.device("cpu")
    if g_cpu is None:
        g_cpu = graph.tensors.to(cpu)
    for k in ("fan_pack", "fanu_pack"):
        if getattr(g_cpu, k) is not None:
            getattr(g_cpu, k).copy_(getattr(graph.tensors, k))
    u_cpu = [tuple(u.cpu() for u in hop) for hop in uniforms]
    with torch.no_grad():
        blocks = same_blocks(flow, graph.tensors, roots, uniforms, g_cpu,
                             u_cpu)
    e_type = blocks[0].e_type
    types = [] if e_type is None else sorted(
        int(t) for t in torch.unique(e_type))
    runs = {}
    for where, m, g, r, u in (
            ("card", copy.deepcopy(model), graph.tensors, roots, uniforms),
            ("cpu", copy.deepcopy(model).to(cpu), g_cpu, roots.cpu(),
             u_cpu)):
        m.train()
        m.zero_grad(set_to_none=True)
        loss = m(g, r, uniforms=u)["loss"]
        loss.backward()
        runs[where] = (loss.detach().cpu(),
                       {k: p.grad.cpu() for k, p in m.named_parameters()})
    (loss_k, grads_k), (loss_c, grads_c) = runs["card"], runs["cpu"]
    check(torch.allclose(loss_k, loss_c, **PARITY_TOL),
          f"train loss card {float(loss_k)} vs CPU {float(loss_c)}")
    diffs = {}
    for k, gk in grads_k.items():
        diffs[k] = float((gk - grads_c[k]).abs().max())
        check(torch.allclose(gk, grads_c[k], **PARITY_TOL),
              f"gradient of {k}: card vs CPU max abs diff {diffs[k]}")
    return dict(sampled_ids_equal=True, edge_types=types,
                loss_card=float(loss_k), loss_cpu=float(loss_c),
                loss_abs_diff=float((loss_k - loss_c).abs()),
                grad_max_abs_diff=max(diffs.values()), n_params=len(diffs))


# --------------------------------------------------------------- phase 12 --

FAMILIES = ("gin", "gat", "rgcn")


def phase_families(graph, dev):
    """gin, gat and rgcn (bench.make_model, f32) at full width: gin and
    gat on the sage graph, rgcn on a graph of the same size with 4 edge
    types and the union rows only. Each: infer of 8192 ids (the serving
    path's counts and checks), two batches profiled, one step card vs
    CPU (sampled ids and types equal, loss and gradients within 1e-4),
    then the train phase (counts, loss, the reservoir redraw of its
    pack) with two steps profiled."""
    t0 = time.perf_counter()
    typed_graph = random_graph(N_NODES, AVG_DEGREE, feat_dim=FEAT_DIM,
                               n_classes=N_CLASSES, seed=0,
                               num_edge_types=bench.RGCN_TYPES,
                               packs=("fanu",))
    check(typed_graph.tensors.fan_pack is None
          and typed_graph.tensors.fanu_pack.device.type == dev.type,
          "the rgcn graph holds the union rows alone, on the card")
    log(f"families: rgcn graph with {bench.RGCN_TYPES} edge types, "
        f"{typed_graph.meta.n_edges} edges, "
        f"{int(typed_graph.tensors.fanu_over_rows.numel())} union "
        f"reservoir rows, built in {time.perf_counter() - t0:.1f} s")
    out = {}
    for i, family in enumerate(FAMILIES):
        g = typed_graph if family == "rgcn" else graph
        model = bench.make_model(family, dev,
                                 generator=torch.Generator().manual_seed(0))
        model.eval()
        with tempfile.TemporaryDirectory() as out_dir:
            _, infer = phase_infer(model, g, out_dir, dev)
        prof = phase_profile(model, g, dev)
        infer.update(profile_host_ms=prof["host_ms"],
                     profile_device_busy_ms=prof["device_busy_ms"],
                     profile_complete=prof["kernel_events_complete"])
        grads = phase_grads(model, g, dev)
        if family == "rgcn":
            check(grads["edge_types"] == [-1] + list(
                range(bench.RGCN_TYPES)),
                f"rgcn's sampled edge types {grads['edge_types']}")
        train = phase_train(model, g, dev, seed=1 + i)
        out[family] = dict(infer=infer, grads=grads, train=train)
        log(f"family {family}: {json.dumps(out[family])}")
    return out


# -------------------------------------------------------------- phase 12b --

def gcn_step(model, g, roots) -> tuple:
    """One training step's loss and every parameter's gradient (copies on
    the CPU); the model's own gradients are left as they were."""
    m = copy.deepcopy(model)
    m.train()
    m.zero_grad(set_to_none=True)
    loss = m(g, roots)["loss"]
    loss.backward()
    return loss.detach().cpu(), {k: p.grad.cpu()
                                 for k, p in m.named_parameters()}


def ell_agg_inputs(blk):
    """A gcn layer's ``_ell_agg`` arguments over the whole-graph block
    ``blk``, as ``GCNConv`` hands them over: (C, w_s, w_l, nbr, tpos)
    with the sym-norm scale and the mask folded into the weights."""
    scale = convs._sym_scale(blk)
    return (blk.fanout, *blk.ell_weights(None, scale), blk.ell_tpos)


def gcn_cell_block(dev):
    """The gcn-train cell's whole-graph ELL block on the card: the
    benchmark's own graph (benchmark/configs/gcn.json: ogbn-arxiv's
    169,343 nodes and 2,332,486 directed edges from graph seed 0), built
    by its harness as a run builds it, one block over every node."""
    from benchmark.harness.supervised import build_graph
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "benchmark", "configs", "gcn.json")) as f:
        cfg = json.load(f)
    _, graph = build_graph(cfg, dev)
    roots = torch.arange(cfg["graph"]["nodes"], dtype=torch.int32,
                         device=dev)
    flow = WholeDataFlow(cfg["model"]["layers"], [(0,)])
    return flow(graph.tensors, roots)[0]


def ell_library_adjacency(C, w_s, w_l, nbr, transpose: bool):
    """The weighted adjacency that ``ell_agg`` applies, as a CSR matrix
    (self loops on its diagonal), transposed for the transpose mode: the
    operand of the library yardstick torch.sparse.mm."""
    N = nbr.shape[0]
    live = nbr >= 0
    rows = torch.arange(N, device=nbr.device)[:, None].expand(N, C)
    src = torch.stack([rows[live], nbr[live].long()])
    if transpose:
        src = src.flip(0)
    idx = torch.cat([src, torch.arange(N, device=nbr.device).repeat(2, 1)],
                    1)
    return torch.sparse_coo_tensor(idx, torch.cat([w_s[live], w_l]),
                                   (N, N)).coalesce().to_sparse_csr()


def time_ell_agg(C, w_s, w_l, nbr, tpos, dev, dims=(FEAT_DIM, 256),
                 what: str = "gcn") -> list:
    """``ops.ell_agg`` alone on one whole-graph block's index and weights
    (the first gcn layer's, as GCNConv hands them over), in both modes
    (forward over nbr; transpose over tpos, the gradient to x), at each
    width of ``dims``, bf16 and f32: CUDA-event medians with L2 flushed,
    each beside its bytes bound (each input read once, each output
    written once), the plain version's time and the library yardstick,
    torch.sparse.mm of the weighted CSR adjacency (its transpose for the
    transpose mode) by x in f32, which the port never calls. The kernel
    is held to the plain version within ELL_AGG_TOL, and sparse.mm to the
    kernel within 1e-4 in f32."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    N, C_in = nbr.shape[0], tpos.shape[1]
    adj = {tr: ell_library_adjacency(C, w_s, w_l, nbr, tr)
           for tr in (False, True)}
    out_rows = []
    for D in dims:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((N, D), generator=gen, device=dev, dtype=dtype)
            elt = x.element_size()
            for tr in (False, True):
                args = (x, tpos if tr else nbr, w_s, w_l, C, tr)
                row = dict(mode="transpose" if tr else "forward",
                           dtype=str(dtype).replace("torch.", ""), N=N, C=C,
                           C_in=C_in, D=D)
                # index [N, C] or [N, C_in] and w_s [N, C] int32/f32, w_l
                # [N], x and out [N, D]
                row["bytes"] = (4 * N * (C_in if tr else C) + 4 * N * C
                                + 4 * N + 2 * N * D * elt)
                row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
                got = ell_ops.ell_agg(*args)
                row["plain_gap"] = ell_agg_gap(got, args)
                check(row["plain_gap"] <= ELL_AGG_TOL[dtype],
                      f"{what} ell_agg {row}: kernel vs plain")
                row["ms"] = time_launches(lambda: ell_ops.ell_agg(*args),
                                          20, flush)
                row["plain_ms"] = time_launches(
                    lambda: ell_ops.ell_agg_plain(*args), 5, flush)
                if dtype == torch.float32:
                    lib = torch.sparse.mm(adj[tr], x)
                    diff = float((lib - got).abs().max())
                    check(torch.allclose(lib, got, **PARITY_TOL),
                          f"{what} sparse.mm vs ell_agg ({row['mode']}, "
                          f"D {D}): max abs diff {diff}")
                    row["library_ms"] = time_launches(
                        lambda: torch.sparse.mm(adj[tr], x), 20, flush)
                    row["library_max_abs_diff"] = diff
                out_rows.append(row)
                log(f"{what}: ell_agg {json.dumps(row)}")
            del x
    return out_rows


def phase_gcn(dev):
    """bench.py's gcn mode in f32 at its published width: the ELL pack's
    widths, serving (infer of 8192 ids: 16 gather_rows and 16 ell_agg
    launches, no fan_draw) and two batches profiled, one step card vs CPU
    (blocks equal, loss and gradients within 1e-4), the ELL layout
    against the edge list on the card (forward within 1e-4), 8 train
    steps over every node (2 gather_rows and 3 ell_agg launches a step)
    with their peak memory, two steps profiled, ``ops.ell_agg`` timed
    alone (``time_ell_agg``), and two steps of the bench's own bf16 model
    profiled with their peak memory; then ``ops.ell_agg`` alone on the
    gcn-train cell's block (``gcn_cell_block``) at D = 128 and 256."""
    t0 = time.perf_counter()
    graph = random_graph(GCN_NODES, AVG_DEGREE, feat_dim=FEAT_DIM,
                         n_classes=N_CLASSES, seed=0, packs=("ell",))
    g = graph.tensors
    check(g.ell_nbr.device.type == dev.type and g.fan_pack is None
          and g.fanu_pack is None,
          "the gcn graph holds the ELL pack alone, on the card")
    widths = (int(g.ell_nbr.shape[1]), int(g.ell_tpos.shape[1]))
    check(widths == (GCN_C, GCN_C_IN), f"ELL widths C, C_in = {widths}")
    out = dict(graph_s=time.perf_counter() - t0, C=widths[0],
               C_in=widths[1], edges=int(graph.meta.n_edges),
               live_cells=int((g.ell_nbr >= 0).sum()))
    log(f"gcn: graph {json.dumps(out)}")
    model = bench.make_model("gcn", dev,
                             generator=torch.Generator().manual_seed(0))
    model.eval()
    roots = torch.arange(GCN_NODES, dtype=torch.int32, device=dev)
    edges = bench.gcn_edges_per_step(GCN_NODES)

    # serving
    with tempfile.TemporaryDirectory() as out_dir:
        emb, infer = phase_infer(
            model, graph, out_dir, dev,
            want=kernel_counts(fan_draw=0, gather_rows=2 * N_INFER // BATCH,
                               ell_agg=bench.GCN_LAYERS * N_INFER // BATCH,
                               sigmoid_xent=HEAD_BATCH * N_INFER // BATCH),
            edges_per_batch=edges)
    prof = phase_profile(model, graph, dev)
    infer.update(profile_host_ms=prof["host_ms"],
                 profile_device_busy_ms=prof["device_busy_ms"],
                 profile_complete=prof["kernel_events_complete"])
    out["infer"] = infer

    # one step card vs CPU: the same blocks, loss and gradients
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    g_cpu = g.to(cpu)
    flow = model.embedder.flow
    with torch.no_grad():
        bk, bc = flow(g, roots)[0], flow(g_cpu, roots.cpu())[0]
        for name in ("n_id", "mask", "src_deg", "ell_tpos"):
            check(torch.equal(getattr(bk, name).cpu(), getattr(bc, name)),
                  f"gcn block {name}: card != CPU")
    loss_k, grads_k = gcn_step(model, g, roots)
    loss_c, grads_c = gcn_step(copy.deepcopy(model).to(cpu), g_cpu,
                               roots.cpu())
    check(torch.allclose(loss_k, loss_c, **PARITY_TOL),
          f"gcn loss card {float(loss_k)} vs CPU {float(loss_c)}")
    diffs = {}
    for k, gk in grads_k.items():
        diffs[k] = float((gk - grads_c[k]).abs().max())
        check(torch.allclose(gk, grads_c[k], **PARITY_TOL),
              f"gcn gradient of {k}: card vs CPU max abs diff {diffs[k]}")
    out["grads"] = dict(blocks_equal=True, loss_card=float(loss_k),
                        loss_cpu=float(loss_c),
                        loss_abs_diff=float((loss_k - loss_c).abs()),
                        grad_max_abs_diff=max(diffs.values()),
                        n_params=len(diffs),
                        seconds=time.perf_counter() - t0)
    del g_cpu
    log(f"gcn: grads {json.dumps(out['grads'])}")

    # the ELL pack against the edge list on the card (index_add_ sums in
    # no fixed order there: a tolerance, never bit for bit)
    edge_list = copy.deepcopy(model)
    edge_list.embedder.flow = WholeDataFlow(bench.GCN_LAYERS, [(0,)],
                                            layout="edge_list")
    with torch.no_grad():
        emb_ell = model(g, roots)["embedding"]
        emb_el = edge_list(g, roots)["embedding"]
    diff = float((emb_ell - emb_el).abs().max())
    check(torch.allclose(emb_ell, emb_el, **PARITY_TOL),
          f"gcn ELL vs edge list: max abs diff {diff}")
    out["ell_vs_edge_list_max_abs_diff"] = diff
    del edge_list, emb_ell, emb_el

    # training: 8 steps over every node
    est = NodeEstimator(model, graph, RunConfig(batch_size=GCN_NODES),
                        device=dev)
    opt = torch.optim.Adam(model.parameters(), 1e-3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    losses = [est.step(opt, roots) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_counts()
    want = kernel_counts(fan_draw=0, gather_rows=2 * TRAIN_STEPS,
                         ell_agg=GCN_ELL_STEP * TRAIN_STEPS,
                         sigmoid_xent=HEAD_STEP * TRAIN_STEPS)
    check(launches == want, f"launches in gcn train {launches}, want {want}")
    losses = [float(x) for x in losses]
    check(bool(np.isfinite(losses).all()), f"gcn train losses {losses}")
    train = dict(launches=launches, losses=losses,
                 train_ms_per_step=train_s / TRAIN_STEPS * 1e3,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    prof = profile(lambda: [est.step(opt, roots) for _ in range(2)],
                   "2 gcn train steps")
    train.update(profile_host_ms=prof["host_ms"],
                 profile_device_busy_ms=prof["device_busy_ms"],
                 profile_idle_share=prof["device_idle_share"],
                 profile_complete=prof["kernel_events_complete"])
    out["train"] = train
    log(f"gcn: train {json.dumps(train)}")
    out["ell_agg"] = time_ell_agg(
        *ell_agg_inputs(model.embedder.flow(g, roots)[0]), dev)
    del est, opt, graph, g

    # the gcn-train cell's own shapes: its graph's block, D = 128 (layer
    # 1's features) and 256 (layers 2 and 3, and their gradients to x)
    blk = gcn_cell_block(dev)
    widths = (int(blk.fanout), int(blk.ell_tpos.shape[1]))
    check(widths == (GCN_CELL_C, GCN_CELL_C),
          f"gcn-train cell's ELL widths C, C_in = {widths}")
    out["ell_agg_cell"] = time_ell_agg(*ell_agg_inputs(blk), dev,
                                       dims=(FEAT_DIM, 256),
                                       what="gcn-train")
    del blk

    # the bench's own bf16 model: two steps profiled after two warm ones
    est = bench.build(dev, GCN_NODES, GCN_NODES, bench.GCN_SIZES["cuda"][1],
                      "gcn")
    opt = torch.optim.Adam(est.model.parameters(), bench.LR)
    for _ in range(2):
        est.step(opt, roots)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = profile(lambda: [est.step(opt, roots) for _ in range(2)],
                   "2 gcn bench steps (bf16)")
    out["bench_bf16_profile"] = dict(
        host_ms=prof["host_ms"], device_busy_ms=prof["device_busy_ms"],
        device_idle_share=prof["device_idle_share"],
        kernels=prof["kernels"][:6],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("gcn: " + json.dumps({"gcn": {
        k: v for k, v in out.items()
        if k not in ("ell_agg", "ell_agg_cell")}}))
    return out


# -------------------------------------------------------------- phase 12n --

# an attention kernel's result against its plain version on the same
# inputs: the largest distance as a share of the plain version over the
# magnitudes (``attn_gap``). Both sum in f32 in other orders (1e-5) and
# round once to the result's type: bf16 results may differ by an ulp,
# 2^-7 of the result, which the magnitudes bound
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7 + 1e-5}


def attn_gap(out: torch.Tensor, plain: torch.Tensor,
             mag: torch.Tensor) -> float:
    return float(((out.float() - plain.float()).abs()
                  / mag.float().clamp_min(1e-30)).max())


def gat_cell_block(dev):
    """The gat-train cell's whole-graph ELL block on the card, built from
    benchmark/configs/gat.json by the benchmark's harness (the gcn cell's
    graph: N 169,343, C = C_in = 36), and the configuration."""
    from benchmark.harness.supervised import build_graph
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "benchmark", "configs", "gat.json")) as f:
        cfg = json.load(f)
    _, graph = build_graph(cfg, dev)
    roots = torch.arange(cfg["graph"]["nodes"], dtype=torch.int32,
                         device=dev)
    flow = WholeDataFlow(cfg["model"]["layers"], [(0,)])
    return flow(graph.tensors, roots)[0], cfg


def gat_gap(out: torch.Tensor, plain: torch.Tensor) -> float:
    """A fused GAT kernel's result against its plain version: the largest
    distance over the plain version's largest value (the scores'
    gradients subtract, so no sum of magnitudes bounds them)."""
    plain = plain.float()
    return float((out.float() - plain).abs().max()
                 / plain.abs().max().clamp_min(1e-30))


# fused GAT kernels against their plain versions (``gat_gap``): f32 sums
# of the same terms in other orders, expf and logf against torch's; the
# forward's bf16 output also an ulp of its largest value
GAT_TOL = 1e-4


#: GAT's three fused entries of csrc/ell_attn.cu, which ``load_parent``
#: takes from the parent's tree too
GAT_ENTRIES = ("etpu_ell_gat", "etpu_ell_gat_sddmm", "etpu_ell_gat_tr")


def with_library(lib, fn):
    """``fn`` (an ``ops.ell_attn`` wrapper) run with ``lib`` (entry name
    -> ctypes function) in place of its kernel library: the same checks,
    outputs and launch through another build of the kernels."""
    def call(*args):
        real = attn_ops.build
        attn_ops.build = lambda: types.SimpleNamespace(**lib)
        try:
            return fn(*args)
        finally:
            attn_ops.build = real
    return call


def phase_gat(dev, parent=None) -> dict:
    """At the gat-train cell's shapes (``gat_cell_block``, H heads of F,
    bf16): GAT's fused modes (``ell_gat``, ``ell_gat_sddmm``,
    ``ell_gat_tr``) on random score terms el and er, and the weighted
    ``ops.ell_sddmm`` (``_ell_agg``'s weight gradient at one head) at H
    heads: each held to its plain version (GAT_TOL, ATTN_TOL), then timed
    with CUDA events, L2 flushed, beside its bytes bound
    (``gat_arith.call_bytes``, imported from the benchmark) and its plain
    version's time (``rows``). With ``parent`` (``load_parent``), each
    fused kernel of the parent's tree too: its outputs equal to this
    checkout's bit for bit, and both timed in turns (parent, change,
    change, parent; ``turns``). Then ``gat_loop_check``. No PyTorch call
    computes a per-head weighted sum: no library yardstick."""
    from benchmark.harness.gat_arith import call_bytes
    from benchmark.harness.supervised import edge_count
    blk, cfg = gat_cell_block(dev)
    m = cfg["model"]
    H, D = m["heads"], m["dims"][0]
    F, N, C = D // H, blk.size[0], blk.fanout
    check((C, int(blk.ell_tpos.shape[1])) == (GCN_CELL_C, GCN_CELL_C),
          f"gat-train cell's ELL widths C = {C}")
    gen = torch.Generator(device=dev).manual_seed(22)
    nbr, tpos = blk.n_id[N:].reshape(N, C), blk.ell_tpos
    dtype = torch.bfloat16
    x, g = (torch.randn((N, D), generator=gen, device=dev, dtype=dtype)
            for _ in range(2))
    xp, gp = attn_ops.pad_heads(x, H), attn_ops.pad_heads(g, H)
    el, er = (2 * torch.randn((N, H), generator=gen, device=dev)
              for _ in range(2))
    a_l, a_r = (torch.randn((H, F), generator=gen, device=dev) / F ** 0.5
                for _ in range(2))
    lse = attn_ops.gat_lse(el, er, nbr)
    grads = attn_ops.ell_gat_sddmm_plain(gp, xp, nbr, el, er, lse)
    nbytes = call_bytes(N, edge_count(cfg["graph"]), D, H,
                        xp.element_size())
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    calls = {
        ("ell_sddmm", "sddmm"): (attn_ops.ell_sddmm, attn_ops.ell_sddmm_plain,
                                 (gp, xp, nbr, True)),
        ("ell_gat", "forward"): (attn_ops.ell_gat, attn_ops.ell_gat_plain,
                                 (xp, nbr, el, er, F)),
        ("ell_gat", "sddmm"): (attn_ops.ell_gat_sddmm,
                               attn_ops.ell_gat_sddmm_plain,
                               (gp, xp, nbr, el, er, lse)),
        ("ell_gat", "transpose"): (attn_ops.ell_gat_tr,
                                   attn_ops.ell_gat_tr_plain,
                                   (gp, attn_ops.live_tpos(tpos, nbr), nbr,
                                    el, er, lse, *grads, a_l, a_r, F))}
    rows = []
    for (kernel, mode), (fn, plain_fn, args) in calls.items():
        got, plain = fn(*args), plain_fn(*args)
        if kernel == "ell_gat":
            gap = max(gat_gap(a, b) for a, b in zip(got, plain))
            tol = GAT_TOL + (2.0 ** -7 if mode == "forward" else 0.0)
        else:
            mag = plain_fn(gp.abs(), xp.abs(), nbr, True)
            gap = max(attn_gap(a, b, c) for a, b, c in zip(got, plain, mag))
            tol = ATTN_TOL[dtype]
        del plain
        torch.cuda.empty_cache()
        row = dict(kernel=kernel, mode=mode, dtype="bfloat16", N=N, C=C,
                   H=H, F=F, bytes=nbytes,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, plain_gap=gap)
        check(gap <= tol, f"gat-train {kernel} {row}: kernel vs plain")
        if parent is not None and kernel == "ell_gat":
            theirs = with_library(parent, fn)
            same = all(torch.equal(a, b) for a, b in zip(got, theirs(*args)))
            check(same, f"gat-train {kernel} {mode}: the parent's outputs "
                  f"differ from this checkout's")
            row["turns"] = time_in_turns(
                {"parent": lambda: theirs(*args), "change": lambda: fn(*args)},
                20, flush)
        del got
        row["ms"] = time_launches(lambda: fn(*args), 20, flush)
        row["plain_ms"] = time_launches(lambda: plain_fn(*args), 2, flush)
        torch.cuda.empty_cache()
        row["roofline"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        log(f"gat: {json.dumps(row)}")
    del blk, x, xp, gp, grads, flush
    torch.cuda.empty_cache()
    return dict(rows=rows, loop=gat_loop_check(dev))


def gat_loop_check(dev) -> dict:
    """Multi-head GAT (3 layers of 3 heads of 8) over every node of a
    3,000-node graph at bf16 activations, as the gat-train cell runs it: a
    TrainLoop of LOOP_SPL steps (one captured step replayed) against as
    many eager steps from the same state, loss and weights bit for bit;
    9 ell_gat launches a step (3 forward, 3 SDDMM, 3 transposes) and the 2
    gathers, held so by a replay, and none of the weighted ell_sddmm."""
    graph = random_graph(3000, 25, feat_dim=16, n_classes=4, seed=0,
                         packs=("ell",), device=dev)
    every = torch.arange(3000, dtype=torch.int32, device=dev)
    runs = []
    for spl in (1, LOOP_SPL):
        gen = torch.Generator().manual_seed(0)
        net = GNNNet("gat", WholeDataFlow(3, [(0,)]), (24,) * 3,
                     ShallowEncoder(("feature",)), in_dim=16,
                     dtype=torch.bfloat16, device=dev, generator=gen,
                     conv_kwargs={"heads": 3})
        est = NodeEstimator(SuperviseModel(net, "label", 4, device=dev,
                                           generator=gen),
                            graph, RunConfig(batch_size=3000), device=dev)
        opt = get_optimizer("adam", 1e-3, est.model.parameters())
        loop = TrainLoop(est, opt, torch.Generator(device=dev).manual_seed(5),
                         spl, lambda: every)
        reset_counts()
        loss = [loop() for _ in range(2 * LOOP_SPL // spl)][-1]
        torch.cuda.synchronize()
        runs.append((est, float(loss), read_counts(), dict(loop.held)))
    (eager, loss_e, n_e, _), (graphed, loss_g, n_g, held) = runs
    steps = 2 * LOOP_SPL
    check(held == kernel_counts(gather_rows=2, ell_gat=9,
                                sigmoid_xent=HEAD_STEP),
          f"gat loop: a replay holds {held}")
    check(n_e == n_g == kernel_counts(gather_rows=2 * steps,
                                      ell_gat=9 * steps,
                                      sigmoid_xent=HEAD_STEP * steps),
          f"gat loop: launches eager {n_e}, replayed {n_g}")
    same = loss_e == loss_g and all(torch.equal(a, b) for a, b in zip(
        graphed.model.parameters(), eager.model.parameters()))
    check(same, f"gat loop: replays {loss_g} vs eager steps {loss_e}")
    return dict(steps=steps, loss=loss_g, held=held, launches=n_g,
                bit_exact=same)


# -------------------------------------------------------------- phase 12c --

def kg_model(cls, dev):
    """A TransX-family model at bench.py's transe width, weights from
    seed 0."""
    return cls(n_entities=TRANSE_NODES, n_relations=bench.TRANSE_RELATIONS,
               ent_dim=bench.TRANSE_DIM, rel_dim=bench.TRANSE_DIM,
               num_negs=bench.TRANSE_NEGS, device=dev,
               generator=torch.Generator().manual_seed(0))


def edge_triples(g, n: int, gen) -> torch.Tensor:
    """int32 [n, 3] (src, dst, etype) from sample_edge over every type."""
    return torch.stack(sampling.sample_edge(g, n, -1, gen)[:3], 1)


def kg_step(model, g, batch, uniforms) -> tuple:
    """One step's outputs and every parameter's gradient (on the CPU), on
    a copy of ``model``."""
    m = copy.deepcopy(model)
    m.train()
    out = m(g, batch, uniforms=uniforms)
    out["loss"].backward()
    return ({k: v.detach().cpu() for k, v in out.items()},
            {k: p.grad.cpu() for k, p in m.named_parameters()})


def check_ranks(model, g, model_cpu, g_cpu, triples, r_card, r_cpu,
                what) -> dict:
    """Full-entity ranks ('both': tail, then head) card vs CPU: equal,
    except where a candidate's order against the true one may flip
    between the two. For each triple whose ranks differ, its scores are
    taken again on both: they must agree within PARITY_TOL, and the ranks
    may differ by no more than the candidates whose CPU score lies within
    twice that tolerance of the true one (the scores are about 16 in
    magnitude, where one f32 step is 1.9e-6). Returns the count of such
    triples and the largest score difference seen."""
    T = len(triples)
    bad = np.nonzero(r_card != r_cpu)[0]
    tol = PARITY_TOL["atol"]
    worst = 0.0
    for i in bad:
        d = "tail" if i < T else "head"
        row = torch.from_numpy(triples[i % T][None])
        with torch.no_grad():
            s_k = model.rank_against_all(g, row.to(g.device), d)[0].cpu()
            s_c = model_cpu.rank_against_all(g_cpu, row, d)[0]
        worst = max(worst, float((s_k - s_c).abs().max()))
        check(torch.allclose(s_k, s_c, **PARITY_TOL),
              f"{what} scores of triple {i % T} ({d}) card vs CPU")
        tgt = int(row[0, 1 if d == "tail" else 0])
        near = (s_c - s_c[tgt]).abs() <= 2 * tol
        near[tgt] = False
        check(int(near.sum()) >= abs(int(r_card[i]) - int(r_cpu[i])),
              f"{what} rank of triple {i % T} ({d}): card {r_card[i]}, CPU "
              f"{r_cpu[i]}, with {int(near.sum())} candidates within "
              f"{2 * tol} of the true score")
    return dict(rank_mismatches=len(bad), mismatch_score_max_diff=worst,
                rank_max_abs_diff=int(np.abs(r_card - r_cpu).max()))


def phase_transe(dev):
    """bench.py's transe mode at its width: the 16-type graph with no
    pack; sample_edge card vs CPU bit for bit (counts 1, 4096 and 4097,
    every type and type 3); TransE through EdgeEstimator: 8 train steps,
    one step card vs CPU (loss and gradients within 1e-4), evaluate (mrr)
    of 4096 triples, full-entity ranking of 64 triples both ways,
    unfiltered and filtered by 100,000 sampled triples (ranks card vs CPU
    under ``check_ranks``' near-tie rule), infer of 8192 triples; TransH, TransR,
    TransD and DistMult one step each (forward card vs CPU within 1e-4);
    no kernel launch in the whole phase; two TransE steps profiled, with
    peak memory."""
    t0 = time.perf_counter()
    graph = random_graph(TRANSE_NODES, AVG_DEGREE, seed=0,
                         num_edge_types=bench.TRANSE_RELATIONS, packs=())
    g = graph.tensors
    ea = g.edge_alias
    check(ea.prob.device.type == dev.type and g.fan_pack is None
          and ea.type_ptr.numel() == bench.TRANSE_RELATIONS + 1,
          "the transe graph: 16 edge types' alias tables on the card, no "
          "pack")
    out = dict(graph_s=time.perf_counter() - t0,
               edges=int(graph.meta.n_edges))
    cpu = torch.device("cpu")
    g_cpu = g.to(cpu)
    reset_counts()

    # the edge draw: card vs CPU from the same uniforms, bit for bit
    gen = torch.Generator(device=dev).manual_seed(21)
    for count in (1, 4096, 4097):
        for edge_type in (-1, 3):
            u = sampling.draw_edge_uniforms(gen, count, dev)
            got = sampling.select_edges(g, edge_type, *u)
            want = sampling.select_edges(g_cpu, edge_type,
                                         *(x.cpu() for x in u))
            check(all(torch.equal(a.cpu(), b) for a, b in zip(got, want)),
                  f"sample_edge card != CPU at {count}, type {edge_type}")
            check(bool((got[0] >= 0).all()), "every drawn edge is valid")
    out["sample_edge_bit_exact"] = True

    # training
    model = kg_model(kg.TransE, dev)
    cfg = RunConfig(batch_size=TRANSE_BATCH, total_steps=TRAIN_STEPS,
                    optimizer="adam", learning_rate=bench.LR,
                    log_steps=TRAIN_STEPS, reservoir_refresh=0, metric="mrr")
    est = EdgeEstimator(model, graph, cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = est.train(log_fn=log)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    check(bool(np.isfinite(res["loss"])), f"transe train loss {res['loss']}")
    out["train"] = dict(loss=res["loss"],
                        train_ms_per_step=train_s / TRAIN_STEPS * 1e3,
                        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    # one step card vs CPU from the same weights, triples and negatives
    gen = torch.Generator(device=dev).manual_seed(22)
    batch = est.train_batch(g, gen)
    u = sampling.draw_node_uniforms(gen, TRANSE_BATCH * bench.TRANSE_NEGS,
                                    dev)
    (ok, gk), (oc, gc) = (
        kg_step(model, g, batch, u),
        kg_step(copy.deepcopy(model).to(cpu), g_cpu, batch.cpu(),
                [x.cpu() for x in u]))
    diffs = {k: float((gk[k] - gc[k]).abs().max()) for k in gk}
    check(torch.allclose(ok["loss"], oc["loss"], **PARITY_TOL),
          f"transe loss card {float(ok['loss'])} vs CPU {float(oc['loss'])}")
    for k in gk:
        check(torch.allclose(gk[k], gc[k], **PARITY_TOL),
              f"transe gradient of {k}: card vs CPU max abs diff {diffs[k]}")
    out["grads"] = dict(loss_card=float(ok["loss"]),
                        loss_cpu=float(oc["loss"]),
                        grad_max_abs_diff=max(diffs.values()))

    # evaluate, full-entity ranking and infer
    ev = est.evaluate(edge_triples(g, 4096, gen).cpu().numpy())
    check(0 < ev["mrr"] <= 1 and np.isfinite(ev["loss"]),
          f"transe evaluate {ev}")
    out["evaluate"] = ev
    rank_est = EdgeEstimator(model, graph, dataclasses.replace(
        cfg, batch_size=RANK_BATCH), device=dev)
    model_cpu = copy.deepcopy(model).to(cpu)
    rank_triples = edge_triples(g, RANK_TRIPLES, gen).cpu().numpy()
    known = edge_triples(g, FILTER_TRIPLES, gen).cpu().numpy()
    out["ranking"] = {}
    for name, fk in (("unfiltered", None), ("filtered", known)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = rank_est.evaluate_ranking(rank_triples, "both", fk)
        card_s = time.perf_counter() - t0
        r_card = kg.entity_ranks(model, g, rank_triples, RANK_BATCH, "both",
                                 fk)
        t0 = time.perf_counter()
        # the CPU in batches of 16: [16, 100,000, 100] f32 temporaries
        r_cpu = kg.entity_ranks(model_cpu, g_cpu, rank_triples, 16, "both",
                                fk)
        cpu_s = time.perf_counter() - t0
        check(summary["mr"] == float(r_card.mean()),
              f"evaluate_ranking's mr {summary['mr']} vs its ranks")
        out["ranking"][name] = dict(
            summary, **check_ranks(model, g, model_cpu, g_cpu, rank_triples,
                                   r_card, r_cpu, name),
            card_s=card_s, cpu_s=cpu_s)
    check(out["ranking"]["filtered"]["mr"]
          <= out["ranking"]["unfiltered"]["mr"], "filtering lowers no rank")
    del model_cpu
    emb = est.infer(edge_triples(g, N_INFER, gen).cpu().numpy())
    check(emb.shape == (N_INFER, bench.TRANSE_DIM)
          and bool(np.isfinite(emb).all()), f"transe infer {emb.shape}")

    # the rest of the family: the forward card vs CPU, then one step
    out["family"] = {}
    for cls in KG_FAMILY:
        m = kg_model(cls, dev)
        e = EdgeEstimator(m, graph, cfg, device=dev)
        batch = e.train_batch(g, gen)
        u = sampling.draw_node_uniforms(
            gen, TRANSE_BATCH * bench.TRANSE_NEGS, dev)
        with torch.no_grad():
            fk = m(g, batch, uniforms=u)
            fc = copy.deepcopy(m).to(cpu)(g_cpu, batch.cpu(),
                                          uniforms=[x.cpu() for x in u])
        diff = max(float((fk[k].cpu() - fc[k]).abs().max())
                   for k in ("loss", "logits", "neg_logits", "embedding"))
        check(all(torch.allclose(fk[k].cpu(), fc[k], **PARITY_TOL)
                  for k in ("loss", "logits", "neg_logits", "embedding")),
              f"{cls.__name__} forward card vs CPU: max abs diff {diff}")
        opt = get_optimizer("adam", bench.LR, m.parameters())
        loss = float(e.step(opt, batch, uniforms=u))
        check(np.isfinite(loss), f"{cls.__name__} train loss {loss}")
        out["family"][cls.__name__] = dict(loss=loss,
                                           forward_max_abs_diff=diff)
        del m, e, opt
    del g_cpu

    # the profile of two bench steps
    opt = get_optimizer("adam", bench.LR, model.parameters())
    for _ in range(2):
        est.step(opt, est.train_batch(g, gen), generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = profile(lambda: [est.step(opt, est.train_batch(g, gen),
                                     generator=gen) for _ in range(2)],
                   "2 transe train steps")
    out["profile"] = dict(
        host_ms=prof["host_ms"], device_busy_ms=prof["device_busy_ms"],
        device_idle_share=prof["device_idle_share"],
        kernels=prof["kernels"][:6],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    launches = read_counts()
    check(launches == kernel_counts(fan_draw=0, gather_rows=0),
          f"launches in the transe phase {launches}, want none")
    out["launches"] = launches
    log(f"transe: {json.dumps(out)}")
    return out


# -------------------------------------------------------------- phase 12d --

def unsup_model(dev) -> UnsuperviseModel:
    """Unsupervised GraphSAGE at the bench's dims: two sage towers over
    SageDataFlow([10, 10]) on the 128-wide feature, one edge type, 20
    negatives; weights from seed 0."""
    gen = torch.Generator().manual_seed(0)

    def net():
        return GNNNet("sage", SageDataFlow(UNSUP_FANOUTS, [(0,)] * 2), DIMS,
                      ShallowEncoder(("feature",)), in_dim=FEAT_DIM,
                      device=dev, generator=gen)
    return UnsuperviseModel(net(), net(), (0,), num_negs=UNSUP_NEGS,
                            device=dev)


def phase_unsup_grads(model, graph, dev) -> dict:
    """One step card vs CPU from the same weights, roots and uniforms (in
    ``UnsuperviseModel``'s order): equal positives, negatives and tower
    blocks, loss and every gradient within 1e-4."""
    g = graph.tensors
    gen = torch.Generator(device=dev).manual_seed(23)
    roots = sampling.sample_node(g, BATCH, -1, gen)
    B, n_neg = BATCH, model.num_negs
    u_pos = sampling.draw_neighbor_uniforms(g, model.edge_types, gen, B, 1,
                                            dev)
    u_neg = sampling.draw_node_uniforms(gen, B * n_neg, dev)
    cpu = torch.device("cpu")
    g_cpu = g.to(cpu)
    with torch.no_grad():
        pos, _ = sampling.select_neighbors(g, roots, model.edge_types, u_pos)
        negs = sampling.select_nodes(g, model.node_type, *u_neg)
        pos_c, _ = sampling.select_neighbors(g_cpu, roots.cpu(),
                                             model.edge_types,
                                             [x.cpu() for x in u_pos])
        negs_c = sampling.select_nodes(g_cpu, model.node_type,
                                       *(x.cpu() for x in u_neg))
        check(torch.equal(pos.cpu(), pos_c) and torch.equal(negs.cpu(),
                                                            negs_c),
              "unsupervised positives and negatives card != CPU")
        towers = []
        for net, r in ((model.embedder, roots),
                       (model.context_embedder, pos[:, 0]),
                       (model.context_embedder, negs)):
            u = hop_uniforms(net.flow, g, r, gen)
            u_c = [tuple(x.cpu() for x in hop) for hop in u]
            same_blocks(net.flow, g, r, u, g_cpu, u_c)
            towers.append((u, u_c))
    uniforms = [u_pos, u_neg] + [u for u, _ in towers]
    u_cpu = [[x.cpu() for x in u_pos], [x.cpu() for x in u_neg]] + [
        u_c for _, u_c in towers]
    (ok, gk), (oc, gc) = (
        kg_step(model, g, roots, uniforms),
        kg_step(copy.deepcopy(model).to(cpu), g_cpu, roots.cpu(), u_cpu))
    check(torch.allclose(ok["loss"], oc["loss"], **PARITY_TOL),
          f"unsupervised loss card {float(ok['loss'])} vs CPU "
          f"{float(oc['loss'])}")
    diffs = {k: float((gk[k] - gc[k]).abs().max()) for k in gk}
    for k in gk:
        check(torch.allclose(gk[k], gc[k], **PARITY_TOL),
              f"unsupervised gradient of {k}: card vs CPU max abs diff "
              f"{diffs[k]}")
    return dict(sampled_ids_equal=True, loss_card=float(ok["loss"]),
                loss_cpu=float(oc["loss"]),
                grad_max_abs_diff=max(diffs.values()), n_params=len(diffs),
                positives_valid=float(ok["pos_mask"].mean()))


def unsup_kernel_shapes(model, graph, dev) -> dict:
    """Both kernels at the shapes the unsupervised step gives them (the
    positive hop, B=1024 and C=1; the negatives tower's two hops, B=20,480
    and 225,280 with C=10; its feature gather, 2,478,080 rows of 128 f32),
    on that tower's own frontiers and ids: each against its plain version
    bit for bit, and timed (CUDA events, L2 flushed) beside its bytes
    bound, its plain version and, for the gather, index_select."""
    g = graph.tensors
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(24)
    roots = sampling.sample_node(g, BATCH, -1, gen)
    negs = sampling.sample_node(g, BATCH * model.num_negs, -1, gen)
    blocks = model.context_embedder.flow(g, negs, generator=gen)
    draws, gathers = [], []
    for nodes, C in ((roots, 1), (negs, UNSUP_FANOUTS[0]),
                     (blocks[-1].n_id, UNSUP_FANOUTS[1])):
        u1, u2 = sampling.draw_fan_uniforms(gen, nodes.shape[0], C, dev)
        args = (g.fan_pack, nodes, 0, 1, u1, u2, -1)
        check(all(torch.equal(a, b) for a, b in zip(
            fd.fan_draw(*args), fd.fan_draw_plain(*args))),
            f"fan_draw != plain at the unsupervised shape B="
            f"{nodes.shape[0]} C={C}")
        nbytes = needed_bytes(g.fan_pack, nodes, u1, u2)
        draws.append(dict(
            B=int(nodes.shape[0]), C=C, bit_exact=True,
            ms=time_launches(lambda: fd.fan_draw(*args), 200, flush),
            plain_ms=time_launches(lambda: fd.fan_draw_plain(*args), 20,
                                   flush),
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3))
    table, ids = g.dense_nf["feature"], blocks[0].n_id
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=dev)
    check(torch.equal(int_view(gr.gather_rows(table, ids, out)),
                      int_view(gr.gather_rows_plain(table, ids))),
          f"gather_rows != plain at the unsupervised shape M={ids.shape[0]}")
    clamped = ids.clamp(0, table.shape[0] - 1)
    nbytes = gather_bytes(table, ids)
    gathers.append(dict(
        N=int(table.shape[0]), D=int(table.shape[1]), M=int(ids.shape[0]),
        dtype=str(table.dtype).replace("torch.", ""), bit_exact=True,
        ms=time_launches(lambda: gr.gather_rows(table, ids, out), 50,
                         flush),
        plain_ms=time_launches(lambda: gr.gather_rows_plain(table, ids), 10,
                               flush),
        library_ms=time_launches(
            lambda: torch.index_select(table, 0, clamped), 50, flush),
        bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3))
    out = dict(fan_draw=draws, gather_rows=gathers)
    log(f"unsup: kernels {json.dumps(out)}")
    return out


def phase_unsup(graph, dev):
    """Unsupervised GraphSAGE on the graph of phase 5: infer of 8192 ids
    (7 fan_draw and 3 gather_rows launches a batch), two batches
    profiled, evaluate (mrr) of 4096 roots, one step card vs CPU, 8 train
    steps with the reservoir redraw (7 and 3 launches a step), two
    profiled."""
    model = unsup_model(dev)
    model.eval()
    kernels = unsup_kernel_shapes(model, graph, dev)
    with tempfile.TemporaryDirectory() as out_dir:
        _, infer = phase_infer(
            model, graph, out_dir, dev,
            want={k: n * N_INFER // BATCH for k, n in UNSUP_LAUNCHES.items()},
            edges_per_batch=UNSUP_EDGES_PER_BATCH)
    prof = phase_profile(model, graph, dev)
    infer.update(profile_host_ms=prof["host_ms"],
                 profile_device_busy_ms=prof["device_busy_ms"],
                 profile_idle_share=prof["device_idle_share"],
                 profile_complete=prof["kernel_events_complete"])
    ev = NodeEstimator(model, graph, RunConfig(batch_size=BATCH,
                                               metric="mrr"),
                       device=dev).evaluate(np.arange(4096))
    check(0 < ev["mrr"] <= 1 and np.isfinite(ev["loss"]),
          f"unsupervised evaluate {ev}")
    grads = phase_unsup_grads(model, graph, dev)
    log(f"unsup: grads {json.dumps(grads)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train = phase_train(model, graph, dev, seed=5, per_step=UNSUP_LAUNCHES)
    train["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out = dict(infer=infer, evaluate=ev, grads=grads, train=train)
    log(f"unsup: {json.dumps(out)}")
    return dict(out, kernels=kernels)


# -------------------------------------------------------------- phase 12e --

# the loop phase: each run is 2 loops of LOOP_SPL steps, the reservoir
# redrawn between them
LOOP_SPL = 5
LOOP_FAMILIES = ("sage", "gin", "gat", "unsup", "rgcn", "gcn", "transe")
# replays in a family's profiled window
PROFILED_REPLAYS = 20
# the steps whose backward sums with atomics, in no fixed order on the card:
# their graph is held to their eager steps within LOOP_TOL; every other
# family's must equal its eager steps bit for bit
ATOMIC_STEPS = {"transe": "Embed's index_add_ backward (the entity and "
                          "relation tables)",
                **{f"encoder_{c}": "Embed's index_add_ backward (the id and "
                                   "sparse-id tables)"
                   for c in ("sum", "mean")}}
LOOP_TOL = dict(rtol=1e-4, atol=1e-5)
# the bench's GNN modes, also held to their eager steps as the bench builds
# and loops them (bf16; transe's bench step is loop_family's own)
LOOP_BENCH_MODES = ("sage", "gin", "gat", "rgcn", "gcn")


class KernelRecorder:
    """While active, every call of the kernel wrappers made during a
    CUDA graph capture (with ``eager``, every call) is recorded with its
    arguments and result. Holding them keeps the capture's tensors alive,
    so that the graph's pool gives their memory to no other tensor of the
    capture: after a replay they hold that replay's inputs and outputs."""

    SITES = ((sampling, "fan_draw"), (encoders, "gather_rows"),
             (feature_ops, "gather_rows"), (knn, "gather_rows"),
             (sharded, "gather_rows"), (block_lib, "ell_agg"),
             (gnn_models, "sigmoid_xent"), (gnn_models, "sigmoid_xent_grad"))

    def __init__(self, eager: bool = False):
        self.calls, self.eager = [], eager

    def __enter__(self):
        self._saved = [(mod, name, getattr(mod, name))
                       for mod, name in self.SITES]
        for mod, name, fn in self._saved:
            setattr(mod, name, self._recording(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def _recording(self, name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.eager or torch.cuda.is_current_stream_capturing():
                self.calls.append((name, args, kwargs, out))
            return out
        return call

    def check_plain(self, what: str) -> dict:
        """Each recorded launch against its plain version on what it read
        (in a capture: in the last replay), bit for bit (gathered rows as
        integers; ell_agg within ELL_AGG_TOL; the loss and its gradient
        within XENT_TOL); the number of launches checked per kernel."""
        n = {k.__name__: 0 for k in COUNTED}
        for name, args, kwargs, out in self.calls:
            if name == "fan_draw":
                want = fd.fan_draw_plain(*args, **kwargs)
                ok = all(torch.equal(a, b) for a, b in zip(out, want))
            elif name == "ell_agg":
                ok = ell_agg_gap(out, args) <= ELL_AGG_TOL[out.dtype]
            elif name == "sigmoid_xent":
                want, den = xent_ops.sigmoid_xent_plain(*args, **kwargs)
                ok = bool(out[1] == den) and \
                    xent_gap(out[0], want) <= XENT_TOL
            elif name == "sigmoid_xent_grad":
                want = xent_ops.sigmoid_xent_grad_plain(*args, **kwargs)
                ok = xent_gap(out, want) <= XENT_TOL
                name = "sigmoid_xent"
            else:
                table, ids = args[:2]
                off = args[3] if len(args) > 3 else kwargs.get(
                    "col_offset", 0)
                rows = out[:, off:off + table.shape[1]]
                ok = torch.equal(int_view(rows),
                                 int_view(gr.gather_rows_plain(table, ids)))
            check(ok, f"{what}: {name} inside a replay != its plain version")
            n[name] += 1
        return n


def loop_family(name: str, make_est, graph, dev, per_step: dict,
                batch_size: int, seed: int, optimizer: str = "adam",
                spl: int = LOOP_SPL) -> dict:
    """One family's loop checks. Two estimators from the same weights and
    seed train 2 loops of ``spl`` steps, one with steps_per_loop = ``spl``
    (a captured step replayed) and one with 1 (eager), from the
    same reservoir rows: their final losses and parameters equal bit for
    bit (within LOOP_TOL for ATOMIC_STEPS), each kernel launched inside
    the replays equal to its plain version, the launch counts equal and
    ``per_step`` a step. Then, on a TrainLoop of its own: two replays
    draw different batches, the replayed and the eager step timed, loops
    of replays profiled (the card's idle share; ``check_held``), and one
    eager step under ``torch.cuda.set_sync_debug_mode("error")``.
    ``optimizer`` trains the two estimators; the loop of its own runs
    Adam."""
    t_start = time.perf_counter()
    g = graph.tensors
    steps = 2 * spl
    cfg = RunConfig(batch_size=batch_size, total_steps=steps,
                    optimizer=optimizer, learning_rate=bench.LR,
                    log_steps=spl, reservoir_refresh=spl,
                    steps_per_loop=spl, seed=seed, metric="mrr")
    graphed = make_est(cfg)
    eager = make_est(dataclasses.replace(cfg, steps_per_loop=1))
    eager.model.load_state_dict(graphed.model.state_dict())
    packs = {k: getattr(g, k).clone() for k in ("fan_pack", "fanu_pack")
             if getattr(g, k) is not None}
    runs = {}
    rec = KernelRecorder()
    for kind, est in (("eager", eager), ("graph", graphed)):
        for k, p in packs.items():
            getattr(g, k).copy_(p)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        if kind == "graph":
            with rec:
                res = est.train(log_fn=lambda _: None)
        else:
            res = est.train(log_fn=lambda _: None)
        torch.cuda.synchronize()
        runs[kind] = dict(res=res, launches=read_counts(),
                          train_s=time.perf_counter() - t0,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    want = {k: n * steps for k, n in per_step.items()}
    for kind, r in runs.items():
        check(r["launches"] == want,
              f"{name}: launches of the {kind} run {r['launches']}, "
              f"want {want}")
    loss_g, loss_e = runs["graph"]["res"]["loss"], runs["eager"]["res"]["loss"]
    check(bool(np.isfinite(loss_g)), f"{name}: loss {loss_g}")
    params_e = dict(eager.model.named_parameters())
    pairs = [(p, params_e[k]) for k, p in graphed.model.named_parameters()]
    max_diff = max(float((p - q).detach().abs().max()) for p, q in pairs)
    bit_equal = loss_g == loss_e and all(torch.equal(p, q) for p, q in pairs)
    if name in ATOMIC_STEPS:
        check(bool(np.isclose(loss_g, loss_e, **LOOP_TOL)) and all(
            torch.allclose(p, q, **LOOP_TOL) for p, q in pairs),
            f"{name}: graph vs eager beyond {LOOP_TOL}: loss {loss_g} vs "
            f"{loss_e}, parameters {max_diff}")
    else:
        check(bit_equal, f"{name}: graph != eager bit for bit: loss "
                         f"{loss_g} vs {loss_e}, parameters {max_diff}")
    in_replay = rec.check_plain(name)
    for k, n in per_step.items():
        check((in_replay[k] > 0) == (n > 0),
              f"{name}: {in_replay[k]} {k} launches recorded in the capture")
    del rec

    # a TrainLoop of its own: draws, times, the profile, no syncs
    gen = torch.Generator(device=dev).manual_seed(seed + 100)
    opt = get_optimizer("adam", bench.LR, graphed.model.parameters())
    seen = []

    def batch():
        seen.append(graphed.train_batch(g, gen))
        return seen[-1]
    loop = TrainLoop(graphed, opt, gen, spl, batch)
    t0 = time.perf_counter()
    loop()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    drawn = []
    for _ in range(2):
        loop()
        drawn.append(seen[-1].clone())
    check(not torch.equal(*drawn), f"{name}: two replays drew one batch")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        loss = loop()
    check(bool(torch.isfinite(loss)), f"{name}: replayed loss finite")
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) / (4 * spl) * 1e3
    loops = max(1, PROFILED_REPLAYS // spl)
    prof = profile(lambda: [loop() for _ in range(loops)],
                   f"{name}: {loops} loops of {spl} replays")
    check_held(loop, per_step, prof, name)

    gen_e = torch.Generator(device=dev).manual_seed(seed + 200)
    opt_e = get_optimizer("adam", bench.LR, eager.model.parameters())
    eager.step(opt_e, eager.train_batch(g, gen_e), generator=gen_e)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4 * LOOP_SPL):
        loss = eager.step(opt_e, eager.train_batch(g, gen_e), generator=gen_e)
    check(bool(torch.isfinite(loss)), f"{name}: eager loss finite")
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / (4 * LOOP_SPL) * 1e3
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager.step(opt_e, eager.train_batch(g, gen_e), generator=gen_e)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()

    out = dict(
        steps_per_loop=spl, steps=steps, optimizer=optimizer,
        bit_equal=bit_equal, atomics=ATOMIC_STEPS.get(name),
        loss_graph=loss_g,
        loss_eager=loss_e, max_param_diff=max_diff,
        launches=runs["graph"]["launches"], held_per_replay=loop.held,
        kernel_launches_checked_in_replay=in_replay, draws_differ=True,
        sync_free_eager_step=True, capture_s=capture_s,
        graph_train_s=runs["graph"]["train_s"],
        eager_train_s=runs["eager"]["train_s"],
        graph_peak_mem_gb=runs["graph"]["peak_mem_gb"],
        eager_peak_mem_gb=runs["eager"]["peak_mem_gb"],
        replay_ms_per_step=replay_ms, eager_ms_per_step=eager_ms,
        profile_host_ms=prof["host_ms"],
        profile_device_busy_ms=prof["device_busy_ms"],
        device_idle_share=prof["device_idle_share"],
        profile_complete=prof["kernel_events_complete"],
        # the profiled busy time a step against the unprofiled replay
        busy_ms_per_step=prof["device_busy_ms"] / (loops * spl),
        top_kernels=prof["kernels"][:5],
        seconds=time.perf_counter() - t_start)
    log(f"loop {name}: {json.dumps(out)}")
    return out


def check_held(loop: TrainLoop, per_step: dict, prof: dict,
               what: str) -> None:
    """The launches a replay of ``loop`` adds to the counts (``held``, the
    launches its capture recorded) are ``per_step``, those of an eager
    step, and the trace of replays in ``prof`` holds one kernel event for
    each launch so counted."""
    check(loop.held == per_step,
          f"{what}: a replay adds {loop.held} launches, a step makes "
          f"{per_step}")
    check(prof["kernel_events_complete"],
          f"{what}: the trace of replays holds {prof['traced']} kernel "
          f"events, the counts {prof['launched']}")


def loop_bench(mode: str, dev, built=None) -> dict:
    """The bench's ``mode`` as bench.run builds and loops it (bench.build:
    bf16 activations, its steps_per_loop; bench.train_loop: the redraw,
    then a captured step replayed; gcn's roots every node): 2 loops
    against the same loops run eagerly, from the same weights, generator
    seed and reservoir rows, the last loss and every parameter equal bit
    for bit and the launch counts equal. Then one loop of replays
    profiled (``check_held``). ``built``: an estimator that bench.build
    made for another mode on the same graph (sage's, gin's and gat's are
    one), whose graph and config this mode's model takes, as bench.build
    would make them."""
    t0 = time.perf_counter()
    if mode == "gcn":
        n_nodes, spl, _ = bench.GCN_SIZES["cuda"]
        batch = n_nodes
        per_step = kernel_counts(fan_draw=0, gather_rows=2,
                                 ell_agg=GCN_ELL_STEP, sigmoid_xent=HEAD_STEP)
    else:
        n_nodes, batch, spl, _ = bench.SIZES["cuda"]
        per_step = kernel_counts(fan_draw=2, gather_rows=2,
                                 sigmoid_xent=HEAD_STEP)
    if built is None:
        graphed = bench.build(dev, n_nodes, batch, spl, mode)
    else:
        graphed = NodeEstimator(
            bench.make_model(mode, dev, torch.bfloat16,
                             torch.Generator().manual_seed(0)),
            built.graph, dataclasses.replace(built.config), device=dev)
    eager = NodeEstimator(
        bench.make_model(mode, dev, torch.bfloat16,
                         torch.Generator().manual_seed(0)),
        graphed.graph, graphed.config, device=dev)
    eager.model.load_state_dict(graphed.model.state_dict())
    g = graphed.graph.tensors
    packs = {k: getattr(g, k).clone() for k in ("fan_pack", "fanu_pack")
             if getattr(g, k) is not None}
    runs = {}
    for kind, est in (("eager", eager), ("graph", graphed)):
        for k, p in packs.items():
            getattr(g, k).copy_(p)
        run = bench.train_loop(est, mode,
                               torch.Generator(device=dev).manual_seed(2))
        run.loop.graphed = kind == "graph"     # the eager run: its steps
        reset_counts()
        for _ in range(2):
            loss = run()
        runs[kind] = dict(run=run, loss=float(loss), launches=read_counts())
    want = {k: n * 2 * spl for k, n in per_step.items()}
    for kind, r in runs.items():
        check(r["launches"] == want, f"bench {mode}: launches of the {kind} "
                                     f"loops {r['launches']}, want {want}")
    loss_g, loss_e = runs["graph"]["loss"], runs["eager"]["loss"]
    pairs = list(zip(graphed.model.parameters(), eager.model.parameters()))
    max_diff = max(float((p - q).float().abs().max()) for p, q in pairs)
    check(bool(np.isfinite(loss_g)) and loss_g == loss_e
          and all(torch.equal(p, q) for p, q in pairs),
          f"bench {mode}: graph != eager bit for bit: loss {loss_g} vs "
          f"{loss_e}, parameters {max_diff}")
    run = runs["graph"]["run"]
    prof = profile(run, f"bench {mode}: a loop of {spl} replays")
    check_held(run.loop, per_step, prof, f"bench {mode}")
    out = dict(steps_per_loop=spl, steps=2 * spl, bit_equal=True,
               loss=loss_g, launches=runs["graph"]["launches"],
               held_per_replay=run.loop.held, traced=prof["traced"],
               device_idle_share=prof["device_idle_share"],
               busy_ms_per_step=prof["device_busy_ms"] / spl,
               seconds=time.perf_counter() - t0)
    log(f"loop bench {mode}: {json.dumps(out)}")
    return dict(out, estimator=graphed)


def loop_hooks(graph, dev) -> dict:
    """Sage through NodeEstimator.train with steps_per_loop = LOOP_SPL, a
    checkpoint every loop (2 kept) and RunConfig.profile: the checkpoints
    left, a fresh estimator (other weights) restoring equal parameters at
    its first infer, and the ProfilerHook's Chrome trace naming both
    kernels."""
    with tempfile.TemporaryDirectory() as d:
        cfg = RunConfig(batch_size=BATCH, total_steps=4 * LOOP_SPL,
                        optimizer="adam", learning_rate=bench.LR,
                        log_steps=0, reservoir_refresh=LOOP_SPL,
                        steps_per_loop=LOOP_SPL, model_dir=d,
                        save_steps=LOOP_SPL, keep_checkpoints=2, profile=True,
                        profile_dir=os.path.join(d, "prof"), seed=9)
        model = bench.make_model("sage", dev,
                                 generator=torch.Generator().manual_seed(0))
        NodeEstimator(model, graph, cfg, device=dev).train(
            log_fn=lambda _: None)
        kept = sorted(os.listdir(os.path.join(d, "ckpt")))
        want = sorted([str(3 * LOOP_SPL), str(4 * LOOP_SPL), "latest"])
        check(kept == want, f"checkpoints kept {kept}, want {want}")
        fresh = bench.make_model("sage", dev,
                                 generator=torch.Generator().manual_seed(1))
        NodeEstimator(fresh, graph, cfg, device=dev).infer(np.arange(BATCH))
        check(all(torch.equal(p, q) for p, q in zip(model.parameters(),
                                                    fresh.parameters())),
              "a fresh estimator restored other parameters")
        traces = os.listdir(cfg.profile_dir)
        check(len(traces) == 1, f"profiler traces {traces}")
        with open(os.path.join(cfg.profile_dir, traces[0])) as f:
            events = json.load(f)["traceEvents"]
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
        named = {k: sorted(n for n in kernels if k in n)
                 for k in ("fan_draw", "gather_rows")}
        check(all(named.values()), f"the trace's kernels name {named}")
    out = dict(checkpoints_kept=kept, restored_equal=True,
               trace_kernels=len(kernels), trace_names=named)
    log(f"loop hooks: {json.dumps(out)}")
    return out


def phase_loop(graph, dev) -> dict:
    """Every family's train loop as a captured step replayed
    (``loop_family``): sage, gin, gat and the unsupervised head on the
    graph of phase 5, rgcn on its 4-type union-row graph, gcn on its ELL
    graph (sampled roots, as NodeEstimator draws them), transe on its
    16-type graph; checkpoints and the profiler hook under the loop
    (``loop_hooks``); then the bench's GNN modes as the bench builds and
    loops them (``loop_bench``)."""
    t0 = time.perf_counter()
    out = {}

    def node_est(model_fn, g):
        return lambda cfg: NodeEstimator(model_fn(), g, cfg, device=dev)

    def gnn(family):
        return lambda: bench.make_model(
            family, dev, generator=torch.Generator().manual_seed(0))
    two = kernel_counts(fan_draw=2, gather_rows=2, sigmoid_xent=HEAD_STEP)
    for i, family in enumerate(("sage", "gin", "gat")):
        out[family] = loop_family(family, node_est(gnn(family), graph),
                                  graph, dev, two, BATCH, 40 + i)
    out["unsup"] = loop_family(
        "unsup", node_est(lambda: unsup_model(dev), graph), graph, dev,
        UNSUP_LAUNCHES, BATCH, 43)
    out["hooks"] = loop_hooks(graph, dev)
    typed = random_graph(N_NODES, AVG_DEGREE, feat_dim=FEAT_DIM,
                         n_classes=N_CLASSES, seed=0,
                         num_edge_types=bench.RGCN_TYPES, packs=("fanu",))
    out["rgcn"] = loop_family("rgcn", node_est(gnn("rgcn"), typed), typed,
                              dev, two, BATCH, 44)
    del typed
    whole = random_graph(GCN_NODES, AVG_DEGREE, feat_dim=FEAT_DIM,
                         n_classes=N_CLASSES, seed=0, packs=("ell",))
    out["gcn"] = loop_family("gcn", node_est(gnn("gcn"), whole), whole, dev,
                             kernel_counts(fan_draw=0, gather_rows=2,
                                           ell_agg=GCN_ELL_STEP,
                                           sigmoid_xent=HEAD_STEP), BATCH,
                             45)
    del whole
    kg_graph = random_graph(TRANSE_NODES, AVG_DEGREE, seed=0,
                            num_edge_types=bench.TRANSE_RELATIONS, packs=())
    out["transe"] = loop_family(
        "transe", lambda cfg: EdgeEstimator(kg_model(kg.TransE, dev),
                                            kg_graph, cfg, device=dev),
        kg_graph, dev, kernel_counts(), TRANSE_BATCH, 46)
    del kg_graph
    out["bench"], sage_bench = {}, None
    for mode in LOOP_BENCH_MODES:
        res = loop_bench(mode, dev,
                         sage_bench if mode in ("gin", "gat") else None)
        est = res.pop("estimator")
        if mode == "sage":
            sage_bench = est
        out["bench"][mode] = res
    del sage_bench
    out["seconds"] = time.perf_counter() - t0
    log(f"loop: {out['seconds']:.1f} s")
    return out


# -------------------------------------------------------------- phase 12f --

def phase_convs(graph, dev) -> dict:
    """The eight convs of bench.CONV_MODES (bench.make_model, f32) at full
    width on the graph of phase 5, each: infer of 8192 ids (16 + 16
    launches); one step card vs CPU (sampled ids equal, loss and every
    gradient within 1e-4); ``loop_family`` (2 loops of LOOP_SPL replays
    bit for bit against 10 eager steps, both kernels equal to their plain
    versions on the last replay's inputs, ``held`` 2 + 2 held against a
    trace of replays, the replayed step's busy time, idle share and peak
    memory)."""
    t0 = time.perf_counter()
    g_cpu = graph.tensors.to(torch.device("cpu"))
    out = {}
    for i, conv in enumerate(bench.CONV_MODES):
        t1 = time.perf_counter()

        def make(conv=conv):
            return bench.make_model(conv, dev,
                                    generator=torch.Generator().manual_seed(0))
        model = make()
        model.eval()
        with tempfile.TemporaryDirectory() as out_dir:
            _, infer = phase_infer(model, graph, out_dir, dev)
        grads = phase_grads(model, graph, dev, g_cpu)
        del model
        loop = loop_family(
            conv, lambda cfg: NodeEstimator(make(), graph, cfg, device=dev),
            graph, dev, kernel_counts(fan_draw=2, gather_rows=2,
                                      sigmoid_xent=HEAD_STEP), BATCH,
            50 + i)
        out[conv] = dict(infer=infer, grads=grads, loop=loop,
                         seconds=time.perf_counter() - t1)
        log(f"conv {conv}: {json.dumps(dict(infer=infer, grads=grads))}")
    out["seconds"] = time.perf_counter() - t0
    log(f"convs: {out['seconds']:.1f} s")
    return out


# -------------------------------------------------------------- phase 12g --

# the examples' whole-graph configurations (examples/{tagcn,sgcn,agnn,
# appnp,arma}, flow_name="whole"), and the node count of the graph on
# which their step is held card against CPU
WHOLE_CONVS = ("tag", "sgcn", "agnn", "appnp", "arma")
WHOLE_CHECK_NODES = 10_000
WHOLE_STEPS = 2
# each conv's ell_agg launches a step over WholeDataFlow(GCN_LAYERS): its
# forward aggregates (tag 3 hops a layer, appnp 10) and the gradients to
# x of those whose x takes one
WHOLE_ELL_AGG = dict(tag=9, sgcn=3, agnn=3, appnp=20, arma=4)
# each conv's ell_sddmm launches a step: _ell_agg's gradient to its
# weights (the one-head SDDMM) where they take one, agnn's attention in
# each of its GCN_LAYERS layers
WHOLE_ELL_SDDMM = dict(agnn=bench.GCN_LAYERS)


def whole_model(conv: str, dev, layout: str = "auto") -> SuperviseModel:
    """``conv`` over ``WholeDataFlow(2, [(0,)])`` at DIMS on the 128-wide
    ``feature``, 16 labels, f32, weights from seed 0."""
    gen = torch.Generator().manual_seed(0)
    net = GNNNet(conv, WholeDataFlow(bench.GCN_LAYERS, [(0,)],
                                     layout=layout),
                 DIMS, ShallowEncoder(("feature",)), in_dim=FEAT_DIM,
                 device=dev, generator=gen)
    return SuperviseModel(net, "label", N_CLASSES, device=dev, generator=gen)


def phase_whole(dev) -> dict:
    """WHOLE_CONVS on phase 12b's graph (random_graph(100_000, 25, ...,
    packs=("ell",))), each: the forward on the ELL pack against the edge
    list on the card (within 1e-4); WHOLE_STEPS train steps over every
    node (2 gather_rows launches a step, no fan_draw), their time and
    peak memory, two more profiled; a TrainLoop of 2 steps (one captured
    step replayed) timed over 2 more loops; one step card vs CPU (loss and
    every gradient within 1e-4) on a WHOLE_CHECK_NODES graph of the same
    kind, which the CPU can afford."""
    t0 = time.perf_counter()
    graph = random_graph(GCN_NODES, AVG_DEGREE, feat_dim=FEAT_DIM,
                         n_classes=N_CLASSES, seed=0, packs=("ell",))
    small = random_graph(WHOLE_CHECK_NODES, AVG_DEGREE, feat_dim=FEAT_DIM,
                         n_classes=N_CLASSES, seed=0, packs=("ell",))
    cpu = torch.device("cpu")
    small_cpu = small.tensors.to(cpu)
    check(graph.tensors.ell_nbr is not None
          and small.tensors.ell_nbr is not None, "ELL packs built")
    roots = torch.arange(GCN_NODES, dtype=torch.int32, device=dev)
    small_roots = torch.arange(WHOLE_CHECK_NODES, dtype=torch.int32,
                               device=dev)
    out = dict(graph_s=time.perf_counter() - t0)
    for conv in WHOLE_CONVS:
        t1 = time.perf_counter()
        model = whole_model(conv, dev)
        edge_list = whole_model(conv, dev, layout="edge_list")
        edge_list.load_state_dict(model.state_dict())
        with torch.no_grad():
            emb_ell = model(graph.tensors, roots)["embedding"]
            emb_el = edge_list(graph.tensors, roots)["embedding"]
        diff = float((emb_ell - emb_el).abs().max())
        check(bool(torch.isfinite(emb_ell).all())
              and torch.allclose(emb_ell, emb_el, **PARITY_TOL),
              f"whole {conv}: ELL vs edge list max abs diff {diff}")
        del edge_list, emb_ell, emb_el

        est = NodeEstimator(model, graph, RunConfig(batch_size=GCN_NODES),
                            device=dev)
        opt = get_optimizer("adam", bench.LR, model.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t2 = time.perf_counter()
        losses = [float(est.step(opt, roots)) for _ in range(WHOLE_STEPS)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t2) / WHOLE_STEPS * 1e3
        launches = read_counts()
        want = kernel_counts(
            fan_draw=0, gather_rows=2 * WHOLE_STEPS,
            ell_agg=WHOLE_ELL_AGG[conv] * WHOLE_STEPS,
            ell_sddmm=WHOLE_ELL_SDDMM.get(conv, 0) * WHOLE_STEPS,
            sigmoid_xent=HEAD_STEP * WHOLE_STEPS)
        check(launches == want,
              f"whole {conv}: launches {launches}, want {want}")
        check(bool(np.isfinite(losses).all()), f"whole {conv}: {losses}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        prof = profile(lambda: [est.step(opt, roots) for _ in range(2)],
                       f"2 whole-graph {conv} train steps")
        gen = torch.Generator(device=dev).manual_seed(60)
        loop = TrainLoop(est, opt, gen, 2, lambda: roots)
        loop()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for _ in range(2):
            loss = loop()
        check(bool(torch.isfinite(loss)), f"whole {conv}: replayed loss")
        torch.cuda.synchronize()
        replay_ms = (time.perf_counter() - t2) / 4 * 1e3
        held = dict(loop.held)
        check(held == kernel_counts(
            fan_draw=0, gather_rows=2, ell_agg=WHOLE_ELL_AGG[conv],
            ell_sddmm=WHOLE_ELL_SDDMM.get(conv, 0), sigmoid_xent=HEAD_STEP),
              f"whole {conv}: a replay holds {held}")
        del loop, est, opt

        loss_k, grads_k = gcn_step(model, small.tensors, small_roots)
        loss_c, grads_c = gcn_step(copy.deepcopy(model).to(cpu), small_cpu,
                                   small_roots.cpu())
        check(torch.allclose(loss_k, loss_c, **PARITY_TOL),
              f"whole {conv}: loss card {float(loss_k)} vs CPU "
              f"{float(loss_c)}")
        diffs = {}
        for k, gk in grads_k.items():
            diffs[k] = float((gk - grads_c[k]).abs().max())
            check(torch.allclose(gk, grads_c[k], **PARITY_TOL),
                  f"whole {conv}: gradient of {k}, card vs CPU max abs "
                  f"diff {diffs[k]}")
        out[conv] = dict(
            ell_vs_edge_list_max_abs_diff=diff, launches=launches,
            losses=losses, train_ms_per_step=step_ms, peak_mem_gb=peak,
            replay_ms_per_step=replay_ms, held_per_replay=held,
            profile_host_ms=prof["host_ms"],
            device_busy_ms_per_step=prof["device_busy_ms"] / 2,
            device_idle_share=prof["device_idle_share"],
            profile_complete=prof["kernel_events_complete"],
            top_kernels=prof["kernels"][:4],
            check_nodes=WHOLE_CHECK_NODES, loss_card=float(loss_k),
            loss_cpu=float(loss_c), grad_max_abs_diff=max(diffs.values()),
            seconds=time.perf_counter() - t1)
        log(f"whole {conv}: {json.dumps(out[conv])}")
        del model
    out["seconds"] = time.perf_counter() - t0
    log(f"whole: {out['seconds']:.1f} s")
    return out


# -------------------------------------------------------------- phase 12h --

# the smoke's sparse feature: up to TAG_WIDTH ids in [0, TAG_IDS) a node,
# hashed into ENC_BUCKETS rows; the id and sparse tables' widths
TAG_WIDTH, TAG_IDS, ENC_BUCKETS, ENC_DIM = 8, 10_000, 1000, 16


def tagged_graph(graph):
    """The graph of phase 5 with a ``tags`` sparse node feature: an
    [N, TAG_WIDTH] int32 table drawn from a numpy seed, ids in
    [0, TAG_IDS), -1 past a random length in 0..TAG_WIDTH (smoke data,
    not a feature of random_graph). The other tensors are shared."""
    rng = np.random.default_rng(21)
    lens = rng.integers(0, TAG_WIDTH + 1, N_NODES).astype(np.int32)
    ids = rng.integers(0, TAG_IDS, (N_NODES, TAG_WIDTH)).astype(np.int32)
    ids[np.arange(TAG_WIDTH)[None, :] >= lens[:, None]] = -1
    out = copy.copy(graph)
    dev = graph.tensors.device
    out.tensors = dataclasses.replace(graph.tensors, sparse_nf={"tags": (
        torch.from_numpy(ids).to(dev), torch.from_numpy(lens).to(dev))})
    return out


def encoder_model(dev, combiner: str, jk: bool = False) -> SuperviseModel:
    """Sage at full width over ShallowEncoder(dense ``feature``, the id
    table of N + 1 rows and ``tags`` in ENC_BUCKETS rows, both ENC_DIM
    wide): GNNNet, or JKGNNNet in concat mode."""
    gen = torch.Generator().manual_seed(0)
    enc = ShallowEncoder(("feature",), use_id=True, max_id=N_NODES - 1,
                         id_dim=ENC_DIM, sparse_names=("tags",),
                         sparse_buckets=ENC_BUCKETS, sparse_dim=ENC_DIM,
                         sparse_combiner=combiner, generator=gen)
    flow = SageDataFlow(FANOUTS, [(0,)] * 2)
    in_dim = ENC_DIM + FEAT_DIM + ENC_DIM
    if jk:
        net = JKGNNNet("sage", flow, DIMS, enc, in_dim, jk_mode="concat",
                       device=dev, generator=gen)
    else:
        net = GNNNet("sage", flow, DIMS, enc, in_dim, device=dev,
                     generator=gen)
    return SuperviseModel(net, "label", N_CLASSES, device=dev, generator=gen)


def phase_encoder(graph, dev) -> dict:
    """Sage over the id and sparse-id encoder on ``tagged_graph``, for the
    sum and the mean combiner: one step card vs CPU (within 1e-4), and
    ``loop_family`` (the replayed loop against eager steps within
    rtol 1e-4 / atol 1e-5: the tables' backward is an index_add_); then
    JKGNNNet("sage", concat) over the same encoder, one step card vs
    CPU. The two loops train with SGD: the order of the atomic sums
    moves a gradient in its last bits, and SGD's step moves with it by
    as little, where Adam's divides by the gradient's running RMS, so an
    element whose sum lies within rounding of zero (a sparse table row
    sums about 2,300 rows a step) steps up to the learning rate apart:
    1.1e-4 after 10 steps on an H100."""
    t0 = time.perf_counter()
    tagged = tagged_graph(graph)
    g_cpu = tagged.tensors.to(torch.device("cpu"))
    out = {}
    for i, comb in enumerate(("sum", "mean")):
        grads = phase_grads(encoder_model(dev, comb), tagged, dev, g_cpu)
        loop = loop_family(
            f"encoder_{comb}",
            lambda cfg, comb=comb: NodeEstimator(encoder_model(dev, comb),
                                                 tagged, cfg, device=dev),
            tagged, dev, kernel_counts(fan_draw=2, gather_rows=2,
                                       sigmoid_xent=HEAD_STEP), BATCH,
            70 + i,
            optimizer="sgd")
        out[comb] = dict(grads=grads, loop=loop)
        log(f"encoder {comb}: grads {json.dumps(grads)}")
    out["jk_concat"] = dict(grads=phase_grads(encoder_model(dev, "sum",
                                                            jk=True),
                                              tagged, dev, g_cpu))
    log(f"encoder jk: {json.dumps(out['jk_concat'])}")
    out["seconds"] = time.perf_counter() - t0
    return out


# -------------------------------------------------------------- phase 12i --

# the walk family at examples/deepwalk/run_deepwalk.py:14-16's and
# examples/line/run_line.py's widths: 64-wide tables, walks of 5 steps,
# windows of 1 and 1 (10 pairs a root), 8 negatives a pair; node2vec
# with p = 0.5, q = 2 over windows of 64 neighbors. The graph is the sage
# graph's, with the reference's general packs and the in-CSR
WALK_PACKS = ("group", "adj", "sample", "fan")
WALK_DIM, WALK_LEN, WALK_NEGS, WALK_CAP = 64, 5, 8, 64
WALK_P, WALK_Q = 0.5, 2.0
WALK_MODELS = ("deepwalk", "node2vec", "line1", "line2")
WALK_SPL, WALK_EVAL = 10, 4096
NO_LAUNCHES = kernel_counts(fan_draw=0, gather_rows=0)
# draws of one step from the hub, and the most rows of a near tie
HUB_DRAWS, NEAR_TIE_SHARE = 200_000, 1e-3


def walk_model(name: str, dev):
    """DeepWalk, Node2Vec, LINE order 1 or order 2 over edge type 0 of
    the N_NODES-node graph; tables from seed 0."""
    gen = torch.Generator().manual_seed(0)
    if name.startswith("line"):
        return LINE(N_NODES, WALK_DIM, (0,), order=int(name[-1]),
                    num_negs=WALK_NEGS, device=dev, generator=gen)
    cls, kw = DeepWalk, {}
    if name == "node2vec":
        cls, kw = Node2Vec, dict(walk_p=WALK_P, walk_q=WALK_Q,
                                 bias_cap=WALK_CAP)
    return cls(N_NODES, WALK_DIM, (0,), walk_len=WALK_LEN, left_win=1,
               right_win=1, num_negs=WALK_NEGS, device=dev, generator=gen,
               **kw)


def to_device(u, dev):
    """Nested arguments: each tensor in tuples and lists moved to ``dev``,
    anything else as it is."""
    if isinstance(u, torch.Tensor):
        return u.to(dev)
    if isinstance(u, (tuple, list)):
        return type(u)(to_device(x, dev) for x in u)
    return u


def near_tie_rows(g, paths, ets, p, q, cap, u_walk) -> torch.Tensor:
    """Rows of exact node2vec walks ``paths`` where a step's two best
    Gumbel-max keys (``walk.exact_keys`` over g) lie within 4 ulps of
    each other: there XLA's log, the CPU's and the card's may pick
    otherwise."""
    near = torch.zeros(paths.shape[0], dtype=torch.bool,
                       device=paths.device)
    for s, keys in enumerate(u_walk):
        prev = paths[:, s - 1] if s else torch.full_like(paths[:, 0], -1)
        sc = torch.cat([walk.exact_keys(g, paths[:, s], prev, tuple(ets), p,
                                        q, -1, cap, win, u)[1]
                        for win, u in enumerate(keys)], dim=1)
        top = sc.topk(2, dim=1).values
        big = top[:, 0].abs()
        ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
        near |= torch.isfinite(top[:, 1]) & (top[:, 0] - top[:, 1] <= 4 * ulp)
    return near


def walk_grads(name: str, model, graph, g_cpu, dev) -> dict:
    """One batch of replayed uniforms through ``model`` on the card and on
    the CPU: LINE's positives and negatives equal and the whole forward;
    DeepWalk's and Node2Vec's walks equal but for rows of near ties
    (under NEAR_TIE_SHARE of the rows), then the skip-gram head on the
    card's walks on both. Loss and every gradient within 1e-4."""
    g = graph.tensors
    gen = torch.Generator(device=dev).manual_seed(31)
    roots = sampling.sample_node(g, BATCH, -1, gen)
    u = model.draw_uniforms(roots, gen)
    u_cpu = to_device(u, "cpu")
    out = {}
    if name.startswith("line"):
        def fwd(m, gg, r, uu):
            return m(gg, r, uniforms=uu)
    else:
        with torch.no_grad():
            paths = model.walk(g, roots, u[0]).cpu()
            paths_cpu = model.walk(g_cpu, roots.cpu(), u_cpu[0])
        near = torch.zeros(BATCH, dtype=torch.bool)
        if name == "node2vec":
            near = near_tie_rows(g_cpu, paths_cpu, (0,), WALK_P, WALK_Q,
                                 WALK_CAP, u_cpu[0])
        differ = (paths != paths_cpu).any(1)
        check(not bool((differ & ~near).any())
              and float(near.float().mean()) < NEAR_TIE_SHARE,
              f"{name}: walks card != CPU in {int(differ.sum())} rows, "
              f"{int(near.sum())} of them near ties")
        out.update(walk_rows_differ=int(differ.sum()),
                   near_tie_rows=int(near.sum()),
                   walk_valid_share=float((paths[:, -1] >= 0).float()
                                          .mean()))

        def fwd(m, gg, r, uu):
            return m.score(gg, r, paths.to(r.device), uu[1])
    runs = []
    for m, gg, r, uu in ((model, g, roots, u),
                         (copy.deepcopy(model).to("cpu"), g_cpu, roots.cpu(),
                          u_cpu)):
        m = copy.deepcopy(m)
        m.train()
        o = fwd(m, gg, r, uu)
        o["loss"].backward()
        runs.append((o, {k: p.grad.cpu() for k, p in m.named_parameters()}))
    (ok, gk), (oc, gc) = runs
    check(torch.equal(ok["pos_mask"].cpu(), oc["pos_mask"]),
          f"{name}: positives card != CPU")
    diffs = {k: float((gk[k] - gc[k]).abs().max()) for k in gk}
    loss_diff = abs(float(ok["loss"]) - float(oc["loss"]))
    check(torch.allclose(ok["loss"].cpu(), oc["loss"], **PARITY_TOL)
          and all(torch.allclose(gk[k], gc[k], **PARITY_TOL) for k in gk),
          f"{name}: card vs CPU loss {loss_diff}, gradients {diffs}")
    out.update(loss_card=float(ok["loss"]), loss_cpu=float(oc["loss"]),
               loss_abs_diff=loss_diff, grad_max_abs_diff=max(diffs.values()),
               n_params=len(diffs),
               pos_valid_share=float(ok["pos_mask"].mean()))
    return out


def walk_hub(graph, dev) -> dict:
    """One step from the highest-degree node, HUB_DRAWS times, unbiased
    and node2vec's first (no previous node: the weights alone): each
    neighbor's share against its share of the hub's edge weights (a
    neighbor on several edges summed), within 5 standard errors and
    1e-4."""
    g = graph.tensors
    gp = g.group_ptr.cpu().numpy().astype(np.int64)
    hub = int(np.diff(gp).argmax())
    lo, hi = gp[hub], gp[hub + 1]
    ids, inv = np.unique(g.adj_dst[lo:hi].cpu().numpy(), return_inverse=True)
    w = np.bincount(inv, g.adj_w[lo:hi].cpu().numpy().astype(np.float64))
    want = w / w.sum()
    gen = torch.Generator(device=dev).manual_seed(32)
    starts = torch.full((HUB_DRAWS,), hub, dtype=torch.int32, device=dev)
    out = dict(hub=hub, degree=int(hi - lo), neighbors=len(ids))
    for name, p, q in (("deepwalk", 1.0, 1.0), ("node2vec", WALK_P, WALK_Q)):
        nxt = walk.random_walk(g, starts, (0,), 1, p, q, bias_cap=WALK_CAP,
                               generator=gen)[:, 1].cpu().numpy()
        pos = np.searchsorted(ids, nxt).clip(0, len(ids) - 1)
        check(bool((ids[pos] == nxt).all()),
              f"hub walk ({name}) left the hub's neighbors")
        got = np.bincount(pos, minlength=len(ids)) / HUB_DRAWS
        err = np.abs(got - want)
        bound = 5 * np.sqrt(want * (1 - want) / HUB_DRAWS) + 1e-4
        check(bool((err <= bound).all()),
              f"hub walk ({name}): shares off the edge weights by up to "
              f"{err.max()} (bound {bound[err.argmax()]})")
        out[name] = dict(max_abs_err=float(err.max()),
                         max_err_over_bound=float((err / bound).max()))
    return out


def walk_serve(model, graph, dev) -> dict:
    """``evaluate`` (mrr) of WALK_EVAL roots and ``infer`` of N_INFER ids,
    neither launching a kernel."""
    est = NodeEstimator(model, graph, RunConfig(batch_size=BATCH,
                                                metric="mrr"), device=dev)
    reset_counts()
    ev = est.evaluate(np.arange(WALK_EVAL))
    check(0 < ev["mrr"] <= 1 and np.isfinite(ev["loss"]),
          f"walk evaluate {ev}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emb = est.infer(np.arange(N_INFER))
    infer_s = time.perf_counter() - t0
    launches = read_counts()
    check(launches == NO_LAUNCHES, f"walk evaluate and infer launched "
                                   f"{launches}")
    check(emb.shape == (N_INFER, WALK_DIM) and bool(np.isfinite(emb).all()),
          f"walk infer: embeddings {emb.shape}, finite "
          f"{bool(np.isfinite(emb).all())}")
    return dict(evaluate=ev, launches=launches,
                infer_ms_per_batch=infer_s / (N_INFER // BATCH) * 1e3)


def both(fn, g, g_cpu, *args, what: str):
    """``fn(g, *args)`` on the card and ``fn(g_cpu, *args on the CPU)``:
    every output equal bit for bit; returns the card's."""
    card = fn(g, *args)
    cpu = fn(g_cpu, *to_device(list(args), "cpu"))
    flat_card, flat_cpu = [], []

    def flatten(x, out):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                flatten(y, out)
    flatten(card, flat_card)
    flatten(cpu, flat_cpu)
    check(len(flat_card) == len(flat_cpu) and all(
        torch.equal(a.cpu(), b) for a, b in zip(flat_card, flat_cpu)),
        f"verbs: {what} card != CPU")
    return card


def labelled_graph(dev):
    """2,000 nodes in 100 graphs of the ``graph_label`` binary feature
    (every 7th node unlabelled), 10,000 random edges."""
    rng = np.random.default_rng(34)
    n, m = 2000, 10_000
    labels = np.array([f"g{i % 100}" if i % 7 else "" for i in range(n)])
    arrays = dict(ext_ids=np.arange(n, dtype=np.int64),
                  node_local=np.arange(n, dtype=np.int32),
                  node_type=np.zeros(n, np.int32),
                  node_w=np.ones(n, np.float32),
                  src=rng.integers(0, n, m).astype(np.int32),
                  dst=rng.integers(0, n, m).astype(np.int32),
                  etype=np.zeros(m, np.int32),
                  ew=np.ones(m, np.float32),
                  eid=np.arange(m, dtype=np.int32))
    arrays["nf_bin:graph_label"] = labels
    meta = GraphMeta(n_nodes=n, n_edges=m, node_types=("n",),
                     edge_types=("e",), node_features=(
                         FeatureSpec("graph_label", "binary", 0),),
                     edge_features=())
    return Graph(meta, arrays, device=dev)


def phase_verbs(graph, g_cpu, dev) -> dict:
    """The verbs of ops/sampling.py, ops/walk.py and ops/util_ops.py on
    the card against the CPU on the same graph and uniforms, bit for bit:
    on 1024 nodes (ids -1 and past the graph among them) the general
    weighted draw on its sample-pack and alias branches, the draw by
    source type, top-k, the in-neighbor draw, full and top-k
    in-neighborhoods, a [10, 5] fanout and its multi-hop adjacency,
    sparse_get_adj of 256 x 1024 nodes, node types, the membership
    test, gen_pair, inflate_idx, unique_gather and sparse_gather; the
    layer draw (sqrt scores, 4 candidates a node, 1024 of them kept)
    equal but for a near tie at its edge; the graph-label verbs on a
    labelled graph of its own."""
    t0 = time.perf_counter()
    g = graph.tensors
    bare = (dataclasses.replace(g, sample_pack=None),
            dataclasses.replace(g_cpu, sample_pack=None))
    gen = torch.Generator(device=dev).manual_seed(33)
    nodes = torch.randint(-1, N_NODES + 2, (BATCH,), generator=gen,
                          device=dev, dtype=torch.int32)
    small = nodes[:256]
    for gg, gc, what in ((g, g_cpu, "sample pack"), (*bare, "alias")):
        both(sampling.select_sampled_neighbors, gg, gc, nodes, (0,),
             *sampling.draw_sample_uniforms(gen, BATCH, 10, dev),
             what=f"sample_neighbor ({what})")
    both(sampling.select_nodes_with_src, g, g_cpu, nodes,
         *sampling.draw_alias_uniforms(gen, (BATCH, 5), dev),
         what="sample_node_with_src")
    both(sampling.get_top_k_neighbor, g, g_cpu, nodes, (0,), 5,
         what="get_top_k_neighbor")
    inn = both(sampling.select_in_neighbors, g, g_cpu, nodes, (0,),
               *sampling.draw_sample_uniforms(gen, BATCH, 10, dev),
               what="sample_in_neighbor")
    both(sampling.get_full_in_neighbor, g, g_cpu, nodes, (0,), 48, -1, True,
         what="get_full_in_neighbor")
    both(sampling.get_top_k_in_neighbor, g, g_cpu, nodes, (0,), 5,
         what="get_top_k_in_neighbor")
    u_fan = sampling.draw_fanout_uniforms(gen, small.shape[0], [10, 5], dev)
    both(sampling.select_fanout, g, g_cpu, small, [(0,), (0,)], [10, 5],
         u_fan, what="sample_fanout")
    both(lambda gg, n, u: sampling.get_multi_hop_neighbor(
        gg, n, [(0,), (0,)], [10, 5], uniforms=u), g, g_cpu, small, u_fan,
        what="get_multi_hop_neighbor")
    nb = torch.randint(-1, N_NODES, (1024,), generator=gen, device=dev,
                       dtype=torch.int32)
    nb[:small.shape[0]] = sampling.get_full_neighbor(g, small, (0,), 1)[0][
        :, 0]
    adj = both(sampling.sparse_get_adj, g, g_cpu, small, nb, (0,),
               what="sparse_get_adj")
    check(bool(adj[0].any()), "sparse_get_adj found no edge")
    both(sampling.get_node_type, g, g_cpu, nodes, what="get_node_type")
    cand = torch.where(torch.rand(inn[0].shape, generator=gen, device=dev)
                       < 0.5, inn[0], nb[:10])
    both(lambda gg, s, c: walk._is_neighbor(gg, s, (0,), c), g, g_cpu,
         nodes[:, None].expand_as(cand).contiguous(), cand,
         what="_is_neighbor")
    paths = torch.randint(-1, N_NODES, (BATCH, WALK_LEN + 1), generator=gen,
                          device=dev, dtype=torch.int32)
    for lw, rw in ((1, 1), (2, 3)):
        both(lambda _, p: walk.gen_pair(p, lw, rw), g, g_cpu, paths,
             what=f"gen_pair({lw}, {rw})")
    idx = torch.randint(0, 5000, (20_000,), generator=gen, device=dev)
    both(lambda _, i: util_ops.inflate_idx(i), g, g_cpu, idx,
         what="inflate_idx")
    table = torch.randn((N_NODES, 16), generator=gen, device=dev)
    both(lambda _, t, i: util_ops.unique_gather(
        lambda x: gr.gather_rows(t, x), i), g, g_cpu, table,
        paths.reshape(-1), what="unique_gather")
    sparse = torch.randint(0, 99, (BATCH, 8), generator=gen, device=dev,
                           dtype=torch.int32)
    both(lambda _, i, s, mk: util_ops.sparse_gather(i, s, mk), g, g_cpu,
         nodes % (BATCH + 3) - 1, sparse, sparse > 20, what="sparse_gather")
    # the layer draw: its keys pass through log
    u_layer = sampling.draw_layer_uniforms(gen, BATCH, 4, dev)
    keep = BATCH
    ids, w = sampling.select_layer(g, nodes, (0,), 4, keep, u_layer)
    ids_c, w_c = sampling.select_layer(g_cpu, nodes.cpu(), (0,), 4, keep,
                                       to_device(u_layer, "cpu"))
    keyed = sampling.layer_keys(g_cpu, nodes.cpu(), (0,), 4,
                                to_device(u_layer, "cpu"))[2]
    top = keyed.sort(descending=True).values
    edge = top[keep - 1]
    near = bool(edge - top[keep] <= 4 * (torch.nextafter(
        edge.abs(), torch.tensor(float("inf"))) - edge.abs()))
    same = torch.equal(ids.cpu().sort().values, ids_c.sort().values)
    check(same or near, "verbs: sample_layer card != CPU")
    # graph labels
    lg = labelled_graph(dev)
    members = both(sampling.get_graph_by_label, lg.tensors,
                   lg.tensors.to("cpu"),
                   torch.tensor([0, 5, 99, -1], dtype=torch.int32,
                                device=dev), what="get_graph_by_label")
    lab = sampling.sample_graph_label(lg.tensors, 4096, generator=gen)
    check(bool(((lab >= 0) & (lab < 100)).all()) and bool(members[1].any()),
          "sample_graph_label out of range")
    out = dict(seconds=time.perf_counter() - t0, layer_equal=same,
               layer_near_tie=near, in_draw_valid=float(
                   (inn[0] >= 0).float().mean()))
    log(f"verbs: {json.dumps(out)}")
    return out


def phase_walk(dev) -> dict:
    """The walk family on the sage graph built with the general packs and
    the in-CSR: ``check_bias_cap`` (no node truncated), ``phase_verbs``,
    the hub's step distribution (``walk_hub``), then DeepWalk, Node2Vec
    and LINE of orders 1 and 2, each: one batch card vs CPU
    (``walk_grads``), evaluate and infer (``walk_serve``), and
    ``loop_family`` with SGD and steps_per_loop = WALK_SPL (replays equal
    to eager steps bit for bit, 0 + 0 launches held and checked against
    a trace, a profiled window of 20 replays)."""
    t0 = time.perf_counter()
    graph = random_graph(N_NODES, AVG_DEGREE, seed=0, packs=WALK_PACKS,
                         build_in_edges=True, device=dev)
    graph_s = time.perf_counter() - t0
    bias = walk.check_bias_cap(graph, (0,), WALK_CAP)
    check(bias[2] == 0, f"node2vec windows truncate: check_bias_cap {bias}")
    log(f"walk: graph built in {graph_s:.1f} s; check_bias_cap (max "
        f"degree, windows needed, truncated nodes) {bias}")
    g_cpu = graph.tensors.to(torch.device("cpu"))
    out = dict(graph_s=graph_s, check_bias_cap=bias,
               verbs=phase_verbs(graph, g_cpu, dev),
               hub=walk_hub(graph, dev))
    log(f"walk: hub {json.dumps(out['hub'])}")
    for i, name in enumerate(WALK_MODELS):
        t1 = time.perf_counter()
        model = walk_model(name, dev)
        res = dict(grads=walk_grads(name, model, graph, g_cpu, dev),
                   serve=walk_serve(model, graph, dev))
        log(f"walk {name}: {json.dumps(res)}")
        del model
        res["loop"] = loop_family(
            name, lambda cfg, name=name: NodeEstimator(
                walk_model(name, dev), graph, cfg, device=dev),
            graph, dev, NO_LAUNCHES, BATCH, 80 + i, optimizer="sgd",
            spl=WALK_SPL)
        res["seconds"] = time.perf_counter() - t1
        out[name] = res
    out["seconds"] = time.perf_counter() - t0
    log(f"walk: {out['seconds']:.1f} s")
    return out


def phase_dedup(graph, dev) -> dict:
    """Sage with ``dedup_features=True`` on the graph of phase 5: on one
    batch of replayed uniforms its embeddings equal those of the plain
    fetch bit for bit, and ``loop_family`` (2 + 2 launches a step, the
    replays bit for bit with eager steps, each gather_rows launch inside
    a replay equal to its plain version, the held launches against a
    trace)."""
    t0 = time.perf_counter()

    def make():
        model = bench.make_model("sage", dev,
                                 generator=torch.Generator().manual_seed(0))
        model.embedder.dedup_features = True
        return model
    plain, dedup = (bench.make_model(
        "sage", dev, generator=torch.Generator().manual_seed(0)), make())
    g = graph.tensors
    gen = torch.Generator(device=dev).manual_seed(35)
    roots = sampling.sample_node(g, BATCH, -1, gen)
    uniforms = hop_uniforms(plain.embedder.flow, g, roots, gen)
    with torch.no_grad():
        a, b = (m(g, roots, uniforms=uniforms)["embedding"]
                for m in (plain, dedup))
    check(torch.equal(a, b), "dedup_features changed the embeddings")
    loop = loop_family("sage_dedup",
                       lambda cfg: NodeEstimator(make(), graph, cfg,
                                                 device=dev),
                       graph, dev,
                       kernel_counts(fan_draw=2, gather_rows=2,
                                     sigmoid_xent=HEAD_STEP), BATCH,
                       90)
    out = dict(embedding_equal=True, loop=loop,
               seconds=time.perf_counter() - t0)
    log(f"dedup: {json.dumps(dict(embedding_equal=True))}")
    return out


# -------------------------------------------------------------- phase 12j --

# this slice's families on one graph: the sage graph's width with the
# general packs (select_layer, sparse_get_adj and scalable's draw read
# them); batch 1024, dims (128, 128), f32, Adam 1e-3
REST_PACKS = ("group", "adj", "sample", "fan")
REST_FANOUTS, REST_NEGS, REST_SPL = [10, 10], 5, 10
# examples/common.py:173-174 at batch 1024: layers of max(64, batch) nodes
LAYER_SIZES, LAYER_CPN = [BATCH, BATCH], 8
LGCN_FANOUTS, LGCN_K = [6, 6], 4
SAMPLE_ROWS = 100_000
# run_graph_conv_example's settings over MotifDataset at MUTAG's count
MOTIF_GRAPHS, MOTIF_FANOUTS, MOTIF_HIDDEN, MOTIF_BATCH = 188, [5, 5], 32, 32
# the card-vs-CPU step: a 10,000-node graph of the same kind
REST_CPU_NODES, REST_CPU_BATCH = 10_000, 128
REST_FAMILIES = ("adaptivegcn", "fastgcn", "gae", "vgae", "dgi",
                 "geniepath", "lgcn", "scalable", "solution",
                 "sample_solution", "solution_samples", "gin_mean",
                 "gin_set2set")
# launches a step: fan_draw per sampled hop of each tower call, gather_rows
# per tower call (features) and per label fetch; the layerwise flows and
# the scalable hop draw through select_sampled_neighbors (no fan_draw)
REST_LAUNCHES = {
    "adaptivegcn": (0, 2), "fastgcn": (0, 2), "gae": (6, 3),
    "vgae": (6, 3), "dgi": (4, 2), "geniepath": (2, 2), "lgcn": (2, 2),
    "scalable": (0, 3), "solution": (2, 2), "sample_solution": (4, 2),
    "solution_samples": (2, 2), "gin_mean": (2, 2), "gin_set2set": (2, 2)}


def rest_model(name: str, dev, n_nodes: int):
    """The family's model, weights from seed 0, for a graph of
    ``n_nodes`` nodes (the scalable store's rows)."""
    gen = torch.Generator().manual_seed(0)
    et = [(0,)] * 2

    def enc():
        return ShallowEncoder(("feature",))

    def gnn(conv, flow, dims=DIMS, in_dim=FEAT_DIM):
        return GNNNet(conv, flow, dims, enc(), in_dim=in_dim, device=dev,
                      generator=gen)

    def sage():
        return gnn("sage", SageDataFlow(REST_FANOUTS, et))

    def sup(net):
        return SuperviseModel(net, "label", N_CLASSES, device=dev,
                              generator=gen)
    if name in ("adaptivegcn", "fastgcn"):
        cls = LayerwiseDataFlow if name == "adaptivegcn" else FastDataFlow
        return sup(gnn("gcn", cls(LAYER_SIZES, et,
                                  candidates_per_node=LAYER_CPN)))
    if name in ("gae", "vgae"):
        cls = GAE if name == "gae" else VGAE
        return cls(gnn("gcn", SageDataFlow(REST_FANOUTS, et)), (0,),
                   num_negs=REST_NEGS, device=dev, generator=gen)
    if name == "dgi":
        return DGI(gnn("gcn", SageDataFlow(REST_FANOUTS, et)),
                   num_negs=REST_NEGS, device=dev, generator=gen)
    if name == "geniepath":
        return sup(GeniePathLazyNet(SageDataFlow(REST_FANOUTS, et), DIMS,
                                    enc(), FEAT_DIM, device=dev,
                                    generator=gen))
    if name == "lgcn":
        return sup(LGCNNet(SageDataFlow(LGCN_FANOUTS, et), DIMS + DIMS[-1:],
                           enc(), FEAT_DIM, k=LGCN_K, device=dev,
                           generator=gen))
    if name == "scalable":
        return sup(ScalableSageNet((0,), 2, DIMS[0], enc(), FEAT_DIM,
                                   n_nodes, fanout=REST_FANOUTS[0],
                                   device=dev, generator=gen))
    if name in ("solution", "solution_samples"):
        return SolutionModel(sage(), "label", N_CLASSES, device=dev,
                             generator=gen)
    if name == "sample_solution":
        return SampleSolutionModel(GroupGNNNet([sage(), sage()], device=dev),
                                   (0,), num_negs=REST_NEGS, device=dev)
    h = MOTIF_HIDDEN
    net = GNNNet("gin", SageDataFlow(MOTIF_FANOUTS, et), (h, h, h), enc(),
                 in_dim=MOTIF_FEATURE_DIM, device=dev, generator=gen)
    pool = SegmentPool(h, MOTIF_BATCH, "mean") if name == "gin_mean" else \
        Set2SetPool(h, MOTIF_BATCH, h, generator=gen)
    return GraphModel(net, pool, MOTIF_CLASSES, device=dev, generator=gen)


def rest_estimator(name: str, model, graph, cfg, dev):
    if name in ("gae", "vgae", "dgi"):
        return GaeEstimator(model, graph, cfg, device=dev)
    if name == "solution_samples":
        rows = np.random.default_rng(7).integers(
            0, graph.meta.n_nodes, (SAMPLE_ROWS, 1))
        return SampleEstimator(model, graph, cfg, rows, device=dev)
    if name.startswith("gin_"):
        return GraphEstimator(model, graph, cfg, "label", MOTIF_CLASSES,
                              device=dev)
    return NodeEstimator(model, graph, cfg, device=dev)


class DrawReplay:
    """Records each draw a model makes (the uniforms and normals of the
    port's draw functions, outermost calls only) and each layer select on
    the card, then replays them, moved to the CPU, in the same order: the
    same step on the CPU from the card's draws. The layer selects are
    replayed too, because their Gumbel keys pass through ``log``, whose
    last bit the card and the CPU may round otherwise; ``check_layers``
    holds each recorded select against the CPU's by the near-tie rule."""

    SITES = ((sampling, "draw_neighbor_uniforms"),
             (sampling, "draw_layer_uniforms"),
             (sampling, "draw_sample_uniforms"),
             (sampling, "draw_node_uniforms"),
             (autoencoders, "draw_normals"), (sampling, "select_layer"))

    def __init__(self):
        self.calls, self.replay, self.depth = [], None, 0

    def __enter__(self):
        self._saved = [(m, n, getattr(m, n)) for m, n in self.SITES]
        for m, n, fn in self._saved:
            setattr(m, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for m, n, fn in self._saved:
            setattr(m, n, fn)

    def replaying(self):
        self.replay = iter(self.calls)
        return self

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            if self.depth:
                return fn(*args, **kwargs)
            if self.replay is not None:
                got, _, out = next(self.replay)
                check(got == name, f"replayed draws out of order: {name} "
                                   f"where {got} was drawn")
                return to_device(out, "cpu")
            self.depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                self.depth -= 1
            self.calls.append((name, (args, kwargs), out))
            return out
        return call

    def check_layers(self, g_cpu) -> dict:
        """Each layer select on the CPU from the card's inputs: ids equal
        at every place but those whose key lies within 4 ulps of a
        neighbour's, and equal as sets unless such a near tie sits at the
        layer's edge; the number of places with a near tie."""
        near_places = selects = 0
        for name, (args, kwargs), out in self.calls:
            if name != "select_layer":
                continue
            selects += 1
            ids = out[0]
            a = to_device(list(args[1:]), "cpu")
            ids_c, _ = self._saved[-1][2](g_cpu, *a, **kwargs)
            g, frontier, ets, cpn, m, u = (g_cpu, *a[:5])
            keyed = sampling.layer_keys(g, frontier, ets, cpn, u, *a[5:])[2]
            top = keyed.sort(descending=True).values[:m + 1]
            ulp = torch.nextafter(top.abs(), torch.tensor(float("inf"))) \
                - top.abs()
            # near[i]: keys i and i + 1 within 4 ulps (False past the keys)
            near = torch.zeros(m + 1, dtype=torch.bool)
            near[:top.numel() - 1] = top[:-1] - top[1:] <= 4 * ulp[:-1]
            tie = near[:m] | torch.cat([near[:1] & False, near[:m - 1]])
            same = ids.cpu() == ids_c
            check(bool(same[~tie].all()), "layer select card != CPU away "
                                          "from a near tie")
            check(torch.equal(ids.cpu().sort().values, ids_c.sort().values)
                  or bool(near[m - 1]), "layer select card != CPU as sets")
            near_places += int(tie.sum())
        return dict(layer_selects=selects, near_tie_places=near_places)


def rest_vs_cpu(name: str, dev) -> dict:
    """One train step of the family on a 10,000-node graph of the same
    kind (the motif graph for the graph families) on the card and on the
    CPU from the same weights, batch and draws (``DrawReplay``): loss and
    every gradient within PARITY_TOL."""
    graph_cls = name.startswith("gin_")
    graph = motif_graph(MOTIF_GRAPHS, device=dev) if graph_cls else \
        random_graph(REST_CPU_NODES, AVG_DEGREE, feat_dim=FEAT_DIM,
                     n_classes=N_CLASSES, seed=0, packs=REST_PACKS,
                     device=dev)
    g, g_cpu = graph.tensors, graph.tensors.to(torch.device("cpu"))
    model = rest_model(name, dev, graph.meta.n_nodes)
    model_cpu = copy.deepcopy(model).to("cpu")
    gen = torch.Generator(device=dev).manual_seed(61)
    if graph_cls:
        n = MOTIF_BATCH
        ids = torch.randint(0, MOTIF_GRAPHS, (n,), generator=gen,
                            device=dev, dtype=torch.int32)
        batch, batch_cpu = (make_graph_batch(gg, i, "label", MOTIF_CLASSES)
                            for gg, i in ((g, ids), (g_cpu, ids.cpu())))
    else:
        n = REST_CPU_BATCH
        batch = sampling.sample_node(g, n, -1, gen)
        batch_cpu = batch.cpu()
    outs = []
    with DrawReplay() as rec:
        for m, gg, b, gn in ((model, g, batch, gen),
                             (model_cpu, g_cpu, batch_cpu, None)):
            m.train()
            m.zero_grad(set_to_none=True)
            outs.append(m(gg, b, generator=gn))
            outs[-1]["loss"].backward()
            rec.replaying()
        layers = rec.check_layers(g_cpu)
    card, cpu = outs
    loss_card, loss_cpu = card["loss"].item(), cpu["loss"].item()
    check(bool(np.isclose(loss_card, loss_cpu, **PARITY_TOL)),
          f"{name}: loss card {loss_card} vs CPU {loss_cpu}")
    grads_cpu = dict(model_cpu.named_parameters())
    diffs = []
    for k, p in model.named_parameters():
        q = grads_cpu[k]
        check(p.grad is not None and q.grad is not None
              and torch.allclose(p.grad.cpu(), q.grad, **PARITY_TOL),
              f"{name}: gradient of {k} card vs CPU")
        diffs.append(float((p.grad.cpu() - q.grad).abs().max()))
    emb_diff = float((card["embedding"].detach().cpu()
                      - cpu["embedding"].detach()).abs().max())
    check(emb_diff <= 1e-4 + 1e-4 * float(cpu["embedding"].abs().max()),
          f"{name}: embeddings card vs CPU differ by {emb_diff}")
    return dict(nodes=graph.meta.n_nodes, batch=n, loss=loss_cpu,
                loss_abs_diff=abs(loss_card - loss_cpu),
                max_grad_abs_diff=max(diffs),
                embedding_max_abs_diff=emb_diff, draws=len(rec.calls),
                **layers)


def rest_loop(name: str, graph, dev, seed: int) -> dict:
    """The family's loop checks at full width: an estimator training one
    loop of REST_SPL steps (the first eager, the next captured and
    replayed) against one training REST_SPL eager steps from the same
    weights, seed and reservoir rows: loss and parameters (and the
    scalable store) equal bit for bit,
    each kernel launch inside the replays equal to its plain version,
    both runs' counts REST_LAUNCHES a step (and the loss's HEAD_STEP where
    the model is a SuperviseModel). Then a TrainLoop of its own:
    a loop of replays timed (host clock) beside eager steps, one loop
    profiled (busy and idle time; ``check_held``), and the peak memory
    of the replayed run."""
    t_start = time.perf_counter()
    g = graph.tensors
    fan, gat = REST_LAUNCHES[name]
    bs = MOTIF_BATCH if name.startswith("gin_") else BATCH
    cfg = RunConfig(batch_size=bs, total_steps=REST_SPL,
                    learning_rate=bench.LR, log_steps=0,
                    reservoir_refresh=0, steps_per_loop=REST_SPL, seed=seed,
                    metric="mrr")

    def make(c):
        return rest_estimator(name, rest_model(name, dev, graph.meta.n_nodes),
                              graph, c, dev)
    graphed = make(cfg)
    eager = make(dataclasses.replace(cfg, steps_per_loop=1))
    eager.model.load_state_dict(graphed.model.state_dict())
    head = HEAD_STEP if isinstance(graphed.model, SuperviseModel) else 0
    per_step = kernel_counts(fan_draw=fan, gather_rows=gat,
                             sigmoid_xent=head)
    runs, rec = {}, KernelRecorder()
    for kind, est in (("eager", eager), ("graph", graphed)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        if kind == "graph":
            with rec:
                res = est.train(log_fn=lambda _: None)
        else:
            res = est.train(log_fn=lambda _: None)
        torch.cuda.synchronize()
        runs[kind] = dict(res=res, launches=read_counts(),
                          train_s=time.perf_counter() - t0,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    want = {k: n * REST_SPL for k, n in per_step.items()}
    for kind, r in runs.items():
        check(r["launches"] == want, f"{name}: launches of the {kind} run "
                                     f"{r['launches']}, want {want}")
    loss_g, loss_e = runs["graph"]["res"]["loss"], runs["eager"]["res"]["loss"]
    check(bool(np.isfinite(loss_g)), f"{name}: loss {loss_g}")
    state_e = eager.model.state_dict()
    pairs = [(v, state_e[k]) for k, v in graphed.model.state_dict().items()]
    max_diff = max(float((p - q).abs().max()) for p, q in pairs)
    bit_equal = loss_g == loss_e and all(torch.equal(p, q) for p, q in pairs)
    check(bit_equal, f"{name}: graph != eager bit for bit: loss {loss_g} "
                     f"vs {loss_e}, state {max_diff}")
    in_replay = rec.check_plain(name)
    for k, n in per_step.items():
        check((in_replay[k] > 0) == (n > 0),
              f"{name}: {in_replay[k]} {k} launches recorded in the capture")
    del rec, eager

    gen = torch.Generator(device=dev).manual_seed(seed + 100)
    opt = get_optimizer("adam", bench.LR, graphed.model.parameters())
    loop = TrainLoop(graphed, opt, gen, REST_SPL,
                     lambda: graphed.train_batch(g, gen))
    loop()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = loop()
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) / REST_SPL * 1e3
    check(bool(torch.isfinite(loss)), f"{name}: replayed loss finite")
    prof = profile(loop, f"{name}: a loop of {REST_SPL} replays")
    check_held(loop, per_step, prof, name)
    gen_e = torch.Generator(device=dev).manual_seed(seed + 200)
    graphed.step(opt, graphed.train_batch(g, gen_e), generator=gen_e)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        loss = graphed.step(opt, graphed.train_batch(g, gen_e),
                            generator=gen_e)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) / 4 * 1e3
    check(bool(torch.isfinite(loss)), f"{name}: eager loss finite")
    return dict(
        steps=REST_SPL, bit_equal=bit_equal,
        loss_graph=loss_g, loss_eager=loss_e, max_state_diff=max_diff,
        launches=runs["graph"]["launches"], held_per_replay=loop.held,
        kernel_launches_checked_in_replay=in_replay,
        replay_ms_per_step=replay_ms, eager_ms_per_step=eager_ms,
        busy_ms_per_step=prof["device_busy_ms"] / REST_SPL,
        device_idle_share=prof["device_idle_share"],
        profile_complete=prof["kernel_events_complete"],
        graph_peak_mem_gb=runs["graph"]["peak_mem_gb"],
        eager_peak_mem_gb=runs["eager"]["peak_mem_gb"],
        graph_train_s=runs["graph"]["train_s"],
        eager_train_s=runs["eager"]["train_s"],
        top_kernels=prof["kernels"][:4],
        seconds=time.perf_counter() - t_start)


def phase_rest(dev) -> dict:
    """This slice's families (REST_FAMILIES): the node families on
    random_graph(200_000, 25, feat_dim=128, n_classes=16, seed=0,
    packs=REST_PACKS), the graph families on motif_graph(188). Each:
    ``rest_loop`` at full width, then ``rest_vs_cpu`` on a 10,000-node
    graph of the same kind."""
    t0 = time.perf_counter()
    graph = random_graph(N_NODES, AVG_DEGREE, feat_dim=FEAT_DIM,
                         n_classes=N_CLASSES, seed=0, packs=REST_PACKS,
                         device=dev)
    motif = motif_graph(MOTIF_GRAPHS, device=dev)
    out = dict(graph_s=time.perf_counter() - t0)
    log(f"rest: graphs built in {out['graph_s']:.1f} s")
    for i, name in enumerate(REST_FAMILIES):
        t1 = time.perf_counter()
        res = dict(loop=rest_loop(name, motif if name.startswith("gin_")
                                  else graph, dev, 300 + i),
                   vs_cpu=rest_vs_cpu(name, dev))
        res["seconds"] = time.perf_counter() - t1
        log(f"rest {name}: {json.dumps(res)}")
        out[name] = res
    out["seconds"] = time.perf_counter() - t0
    log(f"rest: {out['seconds']:.1f} s")
    return out


# -------------------------------------------------------------- phase 12k --

DATA_PARTS, DATA_CHUNK, DATA_TRAIN_SHARE = 4, 1_000_000, 0.7
DATA_LOOP, DATA_RELATIONS, DATA_LOSS_TOL = 10, 4, 1e-5
EXAMPLE_STEPS = 20


def data_input(seed: int = 0) -> dict:
    """The main path's graph as the converter's input, from a numpy seed:
    N_NODES nodes, each "train" with probability DATA_TRAIN_SHARE else
    "test", N_NODES * AVG_DEGREE edges of the one type "link" with weights
    in [0.1, 1.1), a dense FEAT_DIM-wide "feature" and a one-hot
    N_CLASSES-wide "label"."""
    rng = np.random.default_rng(seed)
    m = N_NODES * AVG_DEGREE
    label = np.zeros((N_NODES, N_CLASSES), np.float32)
    label[np.arange(N_NODES), rng.integers(0, N_CLASSES, N_NODES)] = 1
    return dict(
        train=rng.random(N_NODES) < DATA_TRAIN_SHARE,
        src=rng.integers(0, N_NODES, m).astype(np.int32),
        dst=rng.integers(0, N_NODES, m).astype(np.int32),
        ew=rng.random(m, dtype=np.float32) + np.float32(0.1),
        feature=rng.standard_normal((N_NODES, FEAT_DIM), np.float32),
        label=label)


def data_convert(d: dict, out_dir: str) -> dict:
    """``d`` through the port's StreamWriter into DATA_PARTS partitions,
    in chunks of at most DATA_CHUNK rows: the seconds, the traced host
    memory peak of the conversion and the part files' bytes."""
    t0 = time.perf_counter()
    tracemalloc.start()
    w = StreamWriter(out_dir, n_partitions=DATA_PARTS, build_in_edges=False)
    for lo in range(0, N_NODES, DATA_CHUNK):
        sl = slice(lo, lo + DATA_CHUNK)
        w.add_nodes(np.arange(N_NODES)[sl],
                    np.where(d["train"][sl], "train", "test"),
                    dense={"feature": d["feature"][sl],
                           "label": d["label"][sl]})
    for lo in range(0, len(d["src"]), DATA_CHUNK):
        sl = slice(lo, lo + DATA_CHUNK)
        w.add_edges(d["src"][sl], d["dst"][sl], "link", d["ew"][sl])
    meta = w.finalize()
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    parts = [os.path.join(out_dir, f"part_{p}.npz") for p in range(DATA_PARTS)]
    check(meta.n_nodes == N_NODES and meta.n_edges == len(d["src"])
          and meta.n_partitions == DATA_PARTS
          and all(os.path.exists(p) for p in parts),
          f"converted meta {meta}")
    return dict(convert_s=time.perf_counter() - t0,
                convert_traced_peak_gb=peak / 1e9,
                part_bytes=sum(os.path.getsize(p) for p in parts),
                edge_counts=list(meta.part_edge_counts))


def data_load(out_dir: str, dev, **kw):
    """``load_graph(out_dir, device=dev, **kw)`` and its seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = load_graph(out_dir, device=dev, **kw)
    torch.cuda.synchronize()
    return graph, time.perf_counter() - t0


def data_check_loaded(graph, d: dict, edges: bool = True) -> dict:
    """The loaded graph holds what was written: the edges as a multiset
    of (src, dst, weight) (with ``edges``), and the node types, features
    and labels by external id (cast to the table's dtype)."""
    g = graph.tensors
    if edges:
        got = [g.adj_src.cpu().numpy(), g.adj_dst.cpu().numpy(),
               g.adj_w.cpu().numpy()]
        want = [d["src"], d["dst"], d["ew"]]
        for cols in (got, want):
            order = np.lexsort(cols[::-1])
            cols[:] = [c[order] for c in cols]
        check(all(np.array_equal(a, b) for a, b in zip(got, want)),
              "loaded edges != the written (src, dst, weight) multiset")
    local = graph.local_ids(np.arange(N_NODES))
    train = graph.meta.node_type_id("train")
    check(np.array_equal(g.node_type.cpu().numpy()[local] == train,
                         d["train"]), "loaded node types != written")
    for name in ("feature", "label"):
        table = g.dense_nf[name].float().cpu().numpy()[local]
        want_t = torch.from_numpy(d[name]).to(g.dense_nf[name].dtype)
        check(np.array_equal(table, want_t.float().numpy()),
              f"loaded {name} rows != written, by external id")
    return dict(edges_checked=len(d["src"]) if edges else 0,
                nodes_checked=N_NODES)


def data_step(model, graph, dev, want: dict, seed: int) -> dict:
    """One train step of ``model`` on the card against the CPU
    (``phase_grads``: the sampled blocks equal, loss and gradients within
    PARITY_TOL, the loss also within DATA_LOSS_TOL), then one optimizer
    step through NodeEstimator over the "train" nodes with the counts set
    to 0 just before: ``want`` launches."""
    grads = phase_grads(model, graph, dev)
    check(grads["loss_abs_diff"] <= DATA_LOSS_TOL,
          f"loss card vs CPU {grads['loss_abs_diff']} > {DATA_LOSS_TOL}")
    train = graph.meta.node_type_id("train")
    est = NodeEstimator(model, graph, RunConfig(batch_size=BATCH,
                                                learning_rate=bench.LR),
                        train_node_type=train, device=dev)
    opt = get_optimizer("adam", bench.LR, model.parameters())
    gen = torch.Generator(device=dev).manual_seed(seed)
    roots = est.train_batch(graph.tensors, gen)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    loss = est.step(opt, roots, generator=gen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts()
    check(launches == want, f"launches in a step {launches}, want {want}")
    check(bool(torch.isfinite(loss)), f"step loss {float(loss)}")
    check(bool((graph.tensors.node_type[roots.long()] == train).all()),
          "roots outside the train nodes")
    return dict(grads, launches=launches, step_loss=float(loss),
                eager_step_ms=step_ms)


def data_loop(graph, dev, per_step: dict, seed: int) -> dict:
    """Sage's TrainLoop of DATA_LOOP steps (the first eager, one captured,
    the rest replayed) against DATA_LOOP eager steps from the same weights
    and seed: loss and parameters bit for bit, both runs' counts
    ``per_step`` a step; then a loop of replays profiled: busy ms a step,
    idle share, launches held against the trace."""
    cfg = RunConfig(batch_size=BATCH, total_steps=DATA_LOOP,
                    learning_rate=bench.LR, log_steps=0, reservoir_refresh=0,
                    steps_per_loop=DATA_LOOP, seed=seed)
    train = graph.meta.node_type_id("train")

    def make(c):
        model = bench.make_model("sage", dev,
                                 generator=torch.Generator().manual_seed(1))
        return NodeEstimator(model, graph, c, train_node_type=train,
                             device=dev)
    runs = {}
    for kind, c in (("eager", dataclasses.replace(cfg, steps_per_loop=1)),
                    ("graph", cfg)):
        est = make(c)
        reset_counts()
        res = est.train(log_fn=lambda _: None)
        torch.cuda.synchronize()
        runs[kind] = (est, res["loss"], read_counts())
    want = {k: n * DATA_LOOP for k, n in per_step.items()}
    for kind, (_, _, launches) in runs.items():
        check(launches == want,
              f"launches of the {kind} run {launches}, want {want}")
    (eager, loss_e, _), (graphed, loss_g, launches) = runs["eager"], \
        runs["graph"]
    state_e = eager.model.state_dict()
    check(loss_g == loss_e and all(
        torch.equal(v, state_e[k])
        for k, v in graphed.model.state_dict().items()),
        f"replayed loop != eager steps: loss {loss_g} vs {loss_e}")
    gen = torch.Generator(device=dev).manual_seed(seed + 100)
    opt = get_optimizer("adam", bench.LR, graphed.model.parameters())
    loop = TrainLoop(graphed, opt, gen, DATA_LOOP,
                     lambda: graphed.train_batch(graph.tensors, gen))
    loop()
    prof = profile(loop, f"data: a loop of {DATA_LOOP} replays")
    check_held(loop, per_step, prof, "data loop")
    return dict(bit_equal=True, loss=loss_g, launches=launches,
                held_per_replay=loop.held,
                busy_ms_per_step=prof["device_busy_ms"] / DATA_LOOP,
                replay_host_ms_per_step=prof["host_ms"] / DATA_LOOP,
                device_idle_share=prof["device_idle_share"],
                profile_complete=prof["kernel_events_complete"],
                top_kernels=prof["kernels"][:4])


def relation_copy(out_dir: str, dev, seed: int = 0):
    """The converted graph again with each edge given one of
    DATA_RELATIONS relations from a numpy seed, built with the "sample"
    pack that the payload draw reads."""
    arrays = store._load_parts(out_dir)
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = GraphMeta.from_json(f.read())
    arrays["etype"] = np.random.default_rng(seed).integers(
        0, DATA_RELATIONS, len(arrays["etype"])).astype(np.int32)
    meta = dataclasses.replace(meta, edge_types=tuple(
        f"r{i}" for i in range(DATA_RELATIONS)))
    return Graph(meta, arrays, packs=("sample",), device=dev)


def payload_rgcn(dev):
    """RGCN over every relation through SageDataFlow(payload=True): the
    blocks carry each edge's true weight, id and type."""
    gen = torch.Generator().manual_seed(2)
    ets = tuple(range(DATA_RELATIONS))
    net = GNNNet("relation", SageDataFlow(FANOUTS, [ets] * 2, payload=True),
                 DIMS, ShallowEncoder(("feature",)), in_dim=FEAT_DIM,
                 device=dev, generator=gen,
                 conv_kwargs={"num_relations": DATA_RELATIONS},
                 relation_from_etype=True)
    return SuperviseModel(net, "label", N_CLASSES, device=dev, generator=gen)


def data_examples(root: str) -> dict:
    """run_graphsage, run_gcn and run_rgcn through their main(argv) on the
    port's SBM stand-in, converted by the port under ``root``, each
    train_and_evaluate of EXAMPLE_STEPS steps on the card; then
    run_graphsage's infer from the checkpoint it left."""
    scripts = dict(graphsage=run_graphsage, gcn=run_gcn, rgcn=run_rgcn)
    out = {}
    for name, script in scripts.items():
        reset_counts()
        t0 = time.perf_counter()
        res = script.main(["--dataset", "sbm", "--data_dir", root,
                           "--run_mode", "train_and_evaluate",
                           "--total_steps", str(EXAMPLE_STEPS),
                           "--model_dir", os.path.join(root, f"m_{name}")])
        torch.cuda.synchronize()
        check(res["steps"] == EXAMPLE_STEPS
              and all(np.isfinite(v) for v in res.values()),
              f"example {name}: {res}")
        out[name] = dict(res, launches=read_counts(),
                         seconds=time.perf_counter() - t0)
    emb_dir = os.path.join(root, "emb")
    res = run_graphsage.main(["--dataset", "sbm", "--data_dir", root,
                              "--run_mode", "infer", "--infer_dir", emb_dir,
                              "--model_dir", os.path.join(root,
                                                          "m_graphsage")])
    emb = np.load(os.path.join(emb_dir, "embedding_0.npy"))
    check(emb.shape == tuple(res["embeddings"]) and emb.shape[0] > 0
          and bool(np.isfinite(emb).all()), f"example infer {res}")
    out["graphsage_infer"] = dict(embeddings=list(emb.shape))
    check(out["graphsage"]["launches"]["fan_draw"] > 0
          and out["gcn"]["launches"]["fan_draw"] == 0
          and out["rgcn"]["launches"]["fan_draw"] == 0,
          f"example launches {[(n, out[n]['launches']) for n in scripts]}")
    return out


def phase_data(dev) -> dict:
    """The data plane at the main path's width: convert, load and check
    the graph; one sage step over "fan" in f32 and over a bf16 feature
    table, one over packs=() (the fan-less fallback) with its replayed
    loop, the replayed loop over "fan" beside it, one payload rgcn step on
    a 4-relation copy, each card vs CPU; then the three example
    scripts."""
    t_start = time.perf_counter()
    out = {}
    fan_step = kernel_counts(fan_draw=2, gather_rows=2,
                             sigmoid_xent=HEAD_STEP)
    no_fan = kernel_counts(fan_draw=0, gather_rows=2, sigmoid_xent=HEAD_STEP)
    with tempfile.TemporaryDirectory() as root:
        gdir = os.path.join(root, "graph")
        d = data_input()
        out["convert"] = data_convert(d, gdir)
        log(f"data convert: {json.dumps(out['convert'])}")
        graph, out["load_fan_s"] = data_load(gdir, dev, packs=("fan",))
        out["check"] = data_check_loaded(graph, d)
        model = bench.make_model("sage", dev,
                                 generator=torch.Generator().manual_seed(0))
        out["fan_step"] = data_step(model, graph, dev, fan_step, 20)
        out["fan_loop"] = data_loop(graph, dev, fan_step, 21)
        log(f"data fan: {json.dumps(out['fan_step'])} "
            f"{json.dumps(out['fan_loop'])}")
        del graph
        graph, out["load_bf16_s"] = data_load(
            gdir, dev, packs=("fan",), feature_dtype=torch.bfloat16)
        check(graph.tensors.dense_nf["feature"].dtype == torch.bfloat16,
              "bf16 feature table")
        data_check_loaded(graph, d, edges=False)
        out["bf16_step"] = data_step(model, graph, dev, fan_step, 22)
        del graph
        graph, out["load_fallback_s"] = data_load(gdir, dev, packs=())
        check(graph.tensors.fan_pack is None, "packs=() built a fan pack")
        out["fallback_step"] = data_step(model, graph, dev, no_fan, 23)
        out["fallback_loop"] = data_loop(graph, dev, no_fan, 24)
        log(f"data fallback: {json.dumps(out['fallback_step'])} "
            f"{json.dumps(out['fallback_loop'])}")
        del graph, d
        t0 = time.perf_counter()
        graph = relation_copy(gdir, dev)
        out["load_relations_s"] = time.perf_counter() - t0
        out["rgcn_step"] = data_step(payload_rgcn(dev), graph, dev, no_fan,
                                     25)
        check([t for t in out["rgcn_step"]["edge_types"] if t >= 0]
              == list(range(DATA_RELATIONS)),
              f"payload rgcn drew relations {out['rgcn_step']['edge_types']}")
        log(f"data rgcn: {json.dumps(out['rgcn_step'])}")
        del graph
        out["examples"] = data_examples(os.path.join(root, "datasets"))
    out["host_max_rss_gb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1e6
    out["seconds"] = time.perf_counter() - t_start
    log(f"data: {json.dumps(out['examples'])}; {out['seconds']:.1f} s")
    return out


# -------------------------------------------------------------- phase 12l --

QUERY_RUNS = 20
#: the conditional roots' thresholds: feature column 0 of a unit normal
#: (31% of the nodes pass) and the edge weight, uniform in [0.1, 1.1) (20%)
QUERY_FEATURE_T, QUERY_WEIGHT_T = 0.5, 0.9
QUERY_EDGES, QUERY_OUT_CAP, QUERY_LIMIT = 4096, 64, 10
QUERY_LAYER_CPN, QUERY_LAYER_NODES = 8, 1024
IVF_NLIST, IVF_NPROBE, IVF_K, IVF_ITERS = 256, 8, 10, 10
IVF_QUERIES, IVF_BATCH, IVF_ALL_QUERIES = 1024, 256, 256
#: the candidate rows one search batch may gather at nprobe = nlist
IVF_ALL_BYTES = 4 << 30
#: relative gap under which two squared distances count as a near tie
IVF_TIE = 1e-5


def smoke_queries(ids) -> dict:
    """The queries of phase 12l: name -> (a function that makes the
    Query, the graph it runs on, "plain" or "indexed", its gather_rows
    launches)."""
    def roots(q):
        return q.sampleN(-1, BATCH).gt("feature", QUERY_FEATURE_T).alias("n")
    return {
        "sampleNB_values": (lambda q: q.v(ids).sampleNB([0], FANOUTS[0])
                            .alias("nb").values("feature").alias("f"),
                            "plain", 1),
        "sampleN_mask": (roots, "plain", 0),
        "sampleN_index": (roots, "indexed", 0),
        "sampleE_mask": (lambda q: q.sampleE(-1, QUERY_EDGES).gt(
            "weight", QUERY_WEIGHT_T).alias("e"), "plain", 0),
        "outE_udf": (lambda q: q.v(ids).outE([0], QUERY_OUT_CAP).inV()
                     .values(udf_mean("feature"), udf_max("feature"))
                     .alias("m"), "plain", 1),
        "order_by_limit": (lambda q: q.v(ids).sampleNB([0], FANOUTS[0])
                           .order_by("weight", desc=True).limit(QUERY_LIMIT)
                           .alias("top"), "plain", 0),
    }


def flat_result(x, path="out"):
    """(path, tensor) pairs of a query's result dict, in order."""
    if isinstance(x, torch.Tensor):
        return [(path, x)]
    if isinstance(x, dict):
        return [p for k in sorted(x) for p in flat_result(x[k],
                                                          f"{path}.{k}")]
    if isinstance(x, (tuple, list)):
        return [p for i, y in enumerate(x)
                for p in flat_result(y, f"{path}[{i}]")]
    if dataclasses.is_dataclass(x):
        return [p for f in dataclasses.fields(x)
                for p in flat_result(getattr(x, f.name), f"{path}.{f.name}")]
    return []


def same_query_results(card, cpu, what: str, close=()) -> float:
    """Card and CPU results of one query: every tensor equal bit for bit
    (floats as integers, so NaN rows too), those under an alias in
    ``close`` within 1e-6; the largest difference among those."""
    a, b = flat_result(card), flat_result(cpu)
    check([p for p, _ in a] == [p for p, _ in b], f"query {what}: fields")
    err = 0.0
    for (path, x), (_, y) in zip(a, b):
        x = x.cpu()
        check(x.dtype == y.dtype and x.shape == y.shape,
              f"query {what}: {path} {x.dtype} {tuple(x.shape)} vs "
              f"{y.dtype} {tuple(y.shape)}")
        if any(path.startswith(f"out.{c}") for c in close):
            d = float((x - y).abs().max()) if x.numel() else 0.0
            check(d <= 1e-6, f"query {what}: {path} differs by {d}")
            err = max(err, d)
        elif x.dtype.is_floating_point:
            check(torch.equal(int_view(x), int_view(y)),
                  f"query {what}: {path} card != CPU")
        else:
            check(torch.equal(x, y), f"query {what}: {path} card != CPU")
    return err


def time_query(q, gen) -> float:
    """CUDA-event median of QUERY_RUNS runs of ``q`` from ``gen``, ms."""
    times = []
    for _ in range(QUERY_RUNS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        q.run(generator=gen)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def query_phase(graph, dev) -> dict:
    """The queries of ``smoke_queries`` and the layer query on the card
    and on the CPU from the card's uniforms."""
    g = graph.tensors
    g_idx = index_ops.build_attr_index(g, [("feature", 0)])
    on = {"plain": (g, g.to("cpu")), "indexed": (g_idx, g_idx.to("cpu"))}
    rng = np.random.default_rng(40)
    ids_np = rng.integers(0, N_NODES, BATCH).astype(np.int32)
    ids_np[::97] = -1
    ids = torch.from_numpy(ids_np).to(dev)
    out = {}
    for i, (name, (build, where, gathers)) in enumerate(
            smoke_queries(ids).items()):
        gq, gq_cpu = on[where]
        gen = torch.Generator(device=dev).manual_seed(50 + i)
        q = build(Query(gq))
        with KernelRecorder(eager=True) as rec:
            reset_counts()
            card = q.run(generator=gen)
            torch.cuda.synchronize()
            launches = read_counts()
        checked = rec.check_plain(f"query {name}")
        check(launches == kernel_counts(fan_draw=0, gather_rows=gathers)
              and checked["gather_rows"] == gathers,
              f"query {name}: launches {launches}, want {gathers} "
              f"gather_rows and no fan_draw")
        cpu = build(Query(gq_cpu)).run(
            uniforms=to_device(q.last_uniforms, "cpu"))
        udf_err = same_query_results(card, cpu, name, close=("m",))
        frontier = card["_frontier"]
        res = dict(launches=launches, ms=time_query(q, gen),
                   valid=int((frontier.eids if isinstance(frontier,
                                                         EdgeResult)
                              else frontier.ids).ge(0).sum()))
        if name == "outE_udf":
            res["udf_max_abs_err"] = udf_err
        out[name] = res
    # the layer draw: card vs CPU by the near-tie rule of its Gumbel keys
    gen = torch.Generator(device=dev).manual_seed(59)
    q = Query(g).v(ids).sampleLNB([0], QUERY_LAYER_CPN, QUERY_LAYER_NODES)
    with DrawReplay() as rep:
        reset_counts()
        layer = q.run(generator=gen)["_frontier"]
        torch.cuda.synchronize()
        launches = read_counts()
    check(launches == kernel_counts(fan_draw=0, gather_rows=0),
          f"query sampleLNB launches {launches}")
    near = rep.check_layers(on["plain"][1])
    out["sampleLNB"] = dict(launches=launches, ms=time_query(q, gen),
                            valid=int((layer.ids >= 0).sum()), **near)
    log(f"query: {json.dumps(out)}")
    return out


def ivf_recall(queries, emb, got, want) -> dict:
    """Recall@k of ``got`` against the exact ``want`` ids [Q, k]: raw
    (ids in common), and counting as hits the ids whose squared distance
    (float64) lies within IVF_TIE of the exact k-th (a near tie)."""
    q = queries.astype(np.float64)

    def dist(ids):
        return ((emb[np.maximum(ids, 0)].astype(np.float64)
                 - q[:, None, :]) ** 2).sum(-1)
    kth = dist(want).max(axis=1, keepdims=True)
    inside = np.array([np.isin(g, w) for g, w in zip(got, want)])
    tie = (dist(got) <= kth * (1 + IVF_TIE)) & ~inside
    k = want.shape[1]
    valid = got >= 0
    return dict(recall=float((inside & valid).sum() / want.size),
                recall_near_ties=float(((inside | tie) & valid).sum()
                                       / want.size),
                near_tie_hits=int((tie & valid).sum()), k=k)


def kmeans_vs_cpu(emb_dev, emb_cpu, cent0) -> dict:
    """The IVF build's Lloyd steps on the card, each against the CPU's
    step from the same centroids: assignments equal but for points whose
    two nearest centroids lie within IVF_TIE (relative, in float64),
    centroids within 1e-4 in every cluster no such point touched. Returns
    the card's final centroids and the counts."""
    cent, flips, touched, err = cent0, 0, 0, 0.0
    C = cent0.shape[0]
    for _ in range(IVF_ITERS):
        new, a = knn.lloyd_step(emb_dev, cent)
        new_c, a_c = knn.lloyd_step(emb_cpu, cent.cpu())
        a, c = a.cpu(), cent.cpu().double()
        moved = torch.nonzero(a != a_c).ravel()
        keep = torch.ones(C, dtype=torch.bool)
        if moved.numel():
            x = emb_cpu[moved].double()
            da = ((x - c[a[moved]]) ** 2).sum(1)
            db = ((x - c[a_c[moved]]) ** 2).sum(1)
            check(bool(((da - db).abs()
                        <= IVF_TIE * torch.maximum(da, db)).all()),
                  "k-means: card and CPU assign a point otherwise away "
                  "from a near tie")
            keep[a[moved]] = keep[a_c[moved]] = False
        flips += int(moved.numel())
        touched += int((~keep).sum())
        d = float((new.cpu() - new_c)[keep].abs().max())
        check(d <= 1e-4, f"k-means step: centroids card vs CPU {d}")
        err = max(err, d)
        cent = new
    return dict(cent=cent, near_tie_flips=flips, clusters_touched=touched,
                centroid_max_abs_err=err)


def ivf_phase(graph, dev) -> dict:
    """The IVF index over the graph's feature table (see the module
    docstring, phase 12l)."""
    emb = graph.tensors.dense_nf["feature"].cpu().numpy()
    n, D = emb.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = knn.IvfKnnIndex(emb, n_clusters=IVF_NLIST, nprobe=IVF_NPROBE,
                            iters=IVF_ITERS, device=dev)
    torch.cuda.synchronize()
    out = dict(build_s=time.perf_counter() - t0,
               max_members=int(index._members.shape[1]))
    # the same initial centroids as the build's
    cent0 = torch.from_numpy(emb[np.random.default_rng(0).choice(
        n, IVF_NLIST, replace=False)]).to(dev)
    kmeans_ms = {True: [], False: []}
    for fixed in (True, False, False, True):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        cent = knn.kmeans(index._emb, cent0, IVF_ITERS, fixed_order=fixed)
        end.record()
        end.synchronize()
        kmeans_ms[fixed].append(start.elapsed_time(end))
        if fixed:
            check(torch.equal(cent, index._cent),
                  "k-means in a fixed order gave two indexes")
    out.update(kmeans_fixed_order_ms=kmeans_ms[True],
               kmeans_atomic_ms=kmeans_ms[False])
    steps = kmeans_vs_cpu(index._emb, torch.from_numpy(emb), cent0)
    check(torch.equal(steps.pop("cent"), index._cent),
          "k-means step by step != the build's")
    out["kmeans_vs_cpu"] = steps
    end_cpu = knn.kmeans(torch.from_numpy(emb), cent0.cpu(), IVF_ITERS)
    out["centroids_end_to_end_max_abs_diff"] = float(
        (index._cent.cpu() - end_cpu).abs().max())
    queries = np.random.default_rng(7).normal(
        size=(IVF_QUERIES, D)).astype(np.float32)
    _, want = knn.KnnIndex(emb, device=dev).search(queries, IVF_K)
    got, ms = [], []
    reset_counts()
    for b in range(0, IVF_QUERIES, IVF_BATCH):
        with KernelRecorder(eager=b == 0) as rec:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
            start.record()
            got.append(index.search(queries[b:b + IVF_BATCH], IVF_K)[1])
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        if b == 0:
            check(rec.check_plain("ivf search")["gather_rows"] == 1,
                  "ivf search: one gather_rows launch a batch")
            del rec
    out["launches"] = read_counts()
    check(out["launches"] == kernel_counts(
              gather_rows=IVF_QUERIES // IVF_BATCH),
          f"ivf launches {out['launches']}")
    out["ms_per_256_queries"] = statistics.median(ms)
    out[f"nprobe_{IVF_NPROBE}"] = ivf_recall(queries, emb,
                                             np.concatenate(got), want)
    C, maxM = index._members.shape
    qb = max(1, IVF_ALL_BYTES // (C * maxM * D * 4))
    sub = queries[:IVF_ALL_QUERIES]
    got = [index.search(sub[b:b + qb], IVF_K, nprobe=C)[1]
           for b in range(0, len(sub), qb)]
    every = ivf_recall(sub, emb, np.concatenate(got), want[:len(sub)])
    check(every["recall_near_ties"] == 1.0,
          f"ivf recall@{IVF_K} at nprobe = nlist: {every}")
    out[f"nprobe_{C}"] = dict(every, queries_per_batch=qb)
    log(f"ivf: {json.dumps(out)}")
    return out


def phase_query(graph, dev) -> dict:
    t0 = time.perf_counter()
    out = dict(queries=query_phase(graph, dev), ivf=ivf_phase(graph, dev))
    out["seconds"] = time.perf_counter() - t0
    return out


# -------------------------------------------------------------- phase 12m --

EXAMPLE_12M_STEPS = 5
#: (directory, script) of each example runner this slice added
EXAMPLES_12M = [("TransX", s) for s in ("transX", "transE", "transH",
                                        "transR", "transD")] + [
    (d, d) for d in ("distmult", "deepwalk", "line", "gat", "agnn", "appnp",
                     "arma", "sgcn", "tagcn", "dna", "adaptivegcn",
                     "fastgcn", "gin", "graphgcn", "set2set", "gated_graph",
                     "dgi", "gae", "geniepath", "lgcn", "scalable_sage",
                     "solution", "sample_solution")]
#: the scripts whose sampled flow draws over the fan rows (fan_draw), and
#: those that gather no dense feature (the KG and walk tables)
FAN_EXAMPLES = {"dna", "gin", "graphgcn", "set2set", "gated_graph", "dgi",
                "gae", "geniepath", "lgcn", "solution", "sample_solution"}
TABLE_EXAMPLES = {"transX", "transE", "transH", "transR", "transD",
                  "distmult", "deepwalk", "line"}


def phase_examples(dev) -> dict:
    """Each script of EXAMPLES_12M by its main(argv) on its stand-in,
    train_and_evaluate of EXAMPLE_12M_STEPS steps on the card."""
    t_start = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as root:
        for d, script in EXAMPLES_12M:
            mod = importlib.import_module(
                f"euler_tpu_torch.examples.{d}.run_{script}")
            reset_counts()
            t0 = time.perf_counter()
            res = mod.main(argv=[
                "--data_dir", root, "--run_mode", "train_and_evaluate",
                "--total_steps", str(EXAMPLE_12M_STEPS),
                "--model_dir", os.path.join(root, f"m_{script}")])
            torch.cuda.synchronize()
            launches = read_counts()
            check(res["steps"] == EXAMPLE_12M_STEPS
                  and all(np.isfinite(v) for v in res.values()),
                  f"example {script}: {res}")
            check((launches["fan_draw"] > 0) == (script in FAN_EXAMPLES)
                  and (launches["gather_rows"] > 0)
                  == (script not in TABLE_EXAMPLES),
                  f"example {script} launches {launches}")
            out[script] = dict(res, launches=launches,
                               seconds=time.perf_counter() - t0)
    out["seconds"] = time.perf_counter() - t_start
    log(f"examples: {json.dumps(out)}")
    return out


# --------------------------------------------------------------- phase 13 --

def phase_bench(dev):
    """Every mode of the port's bench: three lines each; each kernel 2
    launches per step in the sampled modes, gather_rows 2 and fan_draw
    none in gcn (on the ELL pack), neither in transe; peak memory of gcn
    and transe, and the memory still allocated when the phase starts."""
    out = dict(allocated_before_gb=torch.cuda.memory_allocated() / 1e9)
    log(f"bench: {out['allocated_before_gb']:.3f} GB allocated before the "
        f"first mode")
    for mode in bench.MODELS:
        if mode == "transe":
            want = kernel_counts(fan_draw=0, gather_rows=0)
            metric = bench.TRANSE_METRIC
        elif mode == "gcn":
            _, spl, outer = bench.GCN_SIZES["cuda"]
            steps = spl * (2 + outer)
            want = kernel_counts(fan_draw=0, gather_rows=2 * steps,
                                 ell_agg=GCN_ELL_STEP * steps,
                                 sigmoid_xent=HEAD_STEP * steps)
            metric = bench.GCN_METRIC
        else:
            _, _, spl, outer = bench.SIZES["cuda"]
            steps = spl * (2 + outer)
            want = kernel_counts(fan_draw=2 * steps, gather_rows=2 * steps,
                                 sigmoid_xent=HEAD_STEP * steps)
            metric = bench.METRIC
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        records = bench.run(dev, log=log, model=mode)
        launches = read_counts()
        check(launches == want,
              f"launches in bench {mode} {launches}, want {want}")
        check(len(records) == 3 and all(r["platform"] == "cuda"
                                        and r["model"] == mode
                                        and r["metric"] == metric
                                        and r["vs_baseline"] is None
                                        for r in records),
              f"bench {mode} lines")
        out[mode] = dict(launches=launches,
                         **{f"{r['phase']}_ms_per_step": r["ms_per_step"]
                            for r in records},
                         **{f"{r['phase']}_{r['unit'].split('/')[0]}"
                            f"_per_sec": r["value"] for r in records})
        if mode in ("gcn", "transe"):
            out[mode]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"bench {mode}: {json.dumps(out[mode])}")
    return out


# --------------------------------------------------------------- phase 16 --

# the tools: bench.py's graph-size config at the README's 1M nodes, the
# bench suite, the scaling bench, the ingest drill and the parity harness
TOOLS_NODES = 1_000_000
TOOLS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "tools16")
SUITE_MODES = "sage"
SCALING_NODES, SCALING_STEPS = 5_000, 5
DRILL_ARGS = ["--edges", "10000000", "--nodes", "1000000", "--partitions",
              "4", "--shards", "4", "--steps", "3", "--backend", "gloo"]
PARITY_OTHER_ROWS = ("gin_mutag", "transe_fb15k", "deepwalk_cora")


def tools_probe(run_step) -> dict:
    """One step of a tool in a rank (``run_step``), each kernel launch
    recorded and held against its plain version: the launches counted in
    that step and the launches checked, by kernel."""
    before = read_counts()
    with KernelRecorder(eager=True) as rec:
        run_step()
    torch.cuda.synchronize()
    launches = {k: n - before[k] for k, n in read_counts().items()}
    return dict(launches=launches, checked=rec.check_plain("tool step"))


def time_gather(table, ids, flush) -> dict:
    """gather_rows of ``ids`` from ``table`` against its plain version,
    bit for bit, then its time, the plain version's and
    torch.index_select's (CUDA events, L2 flushed) beside the bytes
    bound."""
    N, D = table.shape
    out = torch.empty((ids.shape[0], D), dtype=table.dtype,
                      device=table.device)
    check(torch.equal(int_view(gr.gather_rows(table, ids, out)),
                      int_view(gr.gather_rows_plain(table, ids))),
          f"gather_rows != plain from [{N}, {D}] {table.dtype}")
    clamped = ids.long().clamp(0, N - 1)
    row = dict(N=N, D=D, M=ids.shape[0],
               dtype=str(table.dtype).replace("torch.", ""),
               bytes=gather_bytes(table, ids))
    row["ms"] = time_launches(lambda: gr.gather_rows(table, ids, out), 200,
                              flush)
    row["plain_ms"] = time_launches(
        lambda: gr.gather_rows_plain(table, ids), 50, flush)
    row["library_ms"] = time_launches(
        lambda: torch.index_select(table, 0, clamped), 200, flush)
    row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
    return row


def tools_bench(dev, smi: str) -> dict:
    """16a: the port's bench at the README's 1M-node config, without and
    with dedup: 2 + 2 launches a step, the captured step's launches equal
    to their plain versions, those launches timed at their shapes; then
    gather_rows at the deepest hop's shape from a [1M, 128] table."""
    out = {}
    _, batch, spl, outer = bench.SIZES["cuda"]
    steps = spl * (2 + outer)
    for dedup in (False, True):
        key = "dedup" if dedup else "plain"
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        reset_counts()
        with KernelRecorder() as rec:
            records = bench.run(dev, log=log, model="sage",
                                nodes=TOOLS_NODES, dedup=dedup)
        launches = read_counts()
        check(launches == kernel_counts(fan_draw=2 * steps,
                                        gather_rows=2 * steps,
                                        sigmoid_xent=HEAD_STEP * steps),
              f"launches in the 1M-node bench ({key}) {launches}")
        checked_n = rec.check_plain(f"the 1M-node bench ({key})")
        check(checked_n == kernel_counts(fan_draw=2, gather_rows=2,
                                         sigmoid_xent=HEAD_STEP),
              f"the 1M-node bench's captured launches {checked_n}")
        config = f"b{batch}_f25x10_n{TOOLS_NODES}"
        check(len(records) == 3 and all(
            r["platform"] == "cuda" and r["config"] == config
            for r in records), f"1M-node bench lines ({key})")
        res = dict(launches=launches, checked=checked_n,
                   seconds=time.perf_counter() - t0,
                   **{f"{r['phase']}_ms_per_step": r["ms_per_step"]
                      for r in records},
                   **{f"{r['phase']}_edges_per_sec": r["value"]
                      for r in records})
        if not dedup:
            res["kernels"] = mesh_kernel_times(rec.calls, dev, "bench 1M")
        del rec
        out[key] = res
        log(f"tools bench 1M ({key}): "
            f"{json.dumps({k: v for k, v in res.items() if k != 'kernels'})}"
            f"; {smi}")
    rng = np.random.default_rng(16)
    gen = torch.Generator(device=dev).manual_seed(16)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ids = gather_ids(rng, GATHER_ROWS, TOOLS_NODES, dev)
    out["gather_1m"] = []
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.randn((TOOLS_NODES, FEAT_DIM), generator=gen,
                            device=dev, dtype=dtype)
        row = time_gather(table, ids, flush)
        del table
        out["gather_1m"].append(row)
        log(f"tools gather 1M: {json.dumps(row)}; {smi}")
    return out


def tools_suite(smi: str) -> dict:
    """16b: the bench suite as a user runs it, into TOOLS_DIR: every mode
    a result and no error, the table printed."""
    path = os.path.join(TOOLS_DIR, "bench_suite.json")
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "euler_tpu_torch.tools.bench_suite",
         "--modes", SUITE_MODES, "--deadline", "300", "--out", path],
        capture_output=True, text=True, timeout=700,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    log(p.stdout)
    check(p.returncode == 0, f"bench_suite exit {p.returncode}: "
          f"{p.stderr[-2000:]}")
    with open(path) as f:
        rec = json.load(f)
    modes = SUITE_MODES.split(",")
    check(sorted(rec["results"]) == sorted(modes) and all(
        "error" not in r and r["platform"] == "cuda"
        for r in rec["results"].values()), f"bench_suite record {rec}")
    check("| family | metric |" in p.stdout, "bench_suite's table")
    out = dict(seconds=time.perf_counter() - t0, results=rec["results"])
    log(f"tools suite: {json.dumps(out)}; {smi}")
    return out


def tools_scaling(link_bytes_per_s: float, smi: str) -> dict:
    """16c: the scaling bench, 1x1 over NCCL, then 1x2 and 1x4 over gloo
    ranks sharing the card with the 1x1 step as --chip-step-ms and phase
    15's measured link rate as --link-gbs: on every rank its record, 2 +
    2 launches a step and each launch of a probed step equal to its plain
    version; the forward bytes equal on the ranks of a shape."""
    common = ["--nodes", str(SCALING_NODES), "--steps", str(SCALING_STEPS)]
    t0 = time.perf_counter()
    runs = scaling_bench.sweep(scaling_bench.parse(
        common + ["--shapes", "1x1", "--backend", "nccl"]), probe=tools_probe)
    one = runs[0]["ranks"][0]
    chip_step_ms = one["seconds"] / SCALING_STEPS * 1e3
    runs += scaling_bench.sweep(scaling_bench.parse(
        common + ["--shapes", "1x2,1x4", "--backend", "gloo",
                  "--chip-step-ms", repr(chip_step_ms), "--link-gbs",
                  repr(link_bytes_per_s / 1e9)]), probe=tools_probe)
    base = runs[0]["record"]["edges_per_sec"]
    out = dict(chip_step_ms=chip_step_ms,
               link_gbs=link_bytes_per_s / 1e9, shapes=[])
    for run in runs:
        rec, ranks = run["record"], run["ranks"]
        check(len(ranks) == rec["devices"], f"scaling {rec['mesh']} ranks")
        for r in ranks:
            check(r["launches"] == kernel_counts(
                      fan_draw=2 * SCALING_STEPS,
                      gather_rows=2 * SCALING_STEPS,
                      sigmoid_xent=HEAD_STEP * SCALING_STEPS),
                  f"scaling {rec['mesh']} rank {r['rank']} launches "
                  f"{r['launches']}")
            two = kernel_counts(fan_draw=2, gather_rows=2,
                                sigmoid_xent=HEAD_STEP)
            check(r["probe"]["checked"] == two
                  and r["probe"]["launches"] == two,
                  f"scaling {rec['mesh']} rank {r['rank']} probe "
                  f"{r['probe']}")
            check(r["forward"] == ranks[0]["forward"],
                  f"scaling {rec['mesh']}: rank {r['rank']}'s forward bytes "
                  f"{r['forward']} != rank 0's {ranks[0]['forward']}")
        check(rec["edges_per_sec"] > 0 and (
            rec["devices"] == 1 or "predicted_chip_efficiency" in rec),
            f"scaling record {rec}")
        out["shapes"].append(dict(
            rec, efficiency_vs_1x1=rec["edges_per_sec"] / (
                base * rec["devices"]),
            step_ms=[r["seconds"] / SCALING_STEPS * 1e3 for r in ranks],
            launches=[r["launches"] for r in ranks]))
    out["seconds"] = time.perf_counter() - t0
    log(f"tools scaling: {json.dumps(out)}; {smi}")
    return out


def tools_drill(smi: str) -> dict:
    """16d: the ingest drill at a reduced scale over 4 gloo ranks sharing
    the card: every stage recorded, a finite DeepWalk loss, each rank's
    probed payload sage step with its gather_rows launches equal to
    their plain version."""
    t0 = time.perf_counter()
    rec = ingest_drill.run(ingest_drill.parse(DRILL_ARGS + [
        "--dir", os.path.join(TOOLS_DIR, "drill")]), probe=tools_probe,
        log=log)
    want = ("generate", "stream_convert", "load_store", "shard_and_place",
            "load_shard", "deepwalk_compile+first_step", "deepwalk_steps",
            "sage_compile+first_step", "sage_steps")
    check(all(s in rec["stages"] for s in want), f"drill stages "
          f"{sorted(rec['stages'])}")
    check(math.isfinite(rec["deepwalk_loss"]), "drill DeepWalk loss")
    for r in rec["ranks"]:
        p = r["probe"]
        check(p["launches"]["gather_rows"] > 0 and p["checked"] ==
              p["launches"], f"drill rank {r['rank']} probe {p}")
        check(math.isfinite(r["sage_loss"]), f"drill rank {r['rank']} "
              f"sage loss")
    out = dict(record=rec, seconds=time.perf_counter() - t0)
    log(f"tools drill: {json.dumps(out)}; {smi}")
    return out


def tools_parity(smi: str) -> dict:
    """16e: the parity harness on the miniature cora fixture (every
    _cora row ran with a delta) and one row of each other family on its
    stand-in; no row an error."""
    t0 = time.perf_counter()
    root = os.path.join(TOOLS_DIR, "parity")
    shutil.rmtree(root, ignore_errors=True)
    raw = os.path.join(root, "data", "cora")
    os.makedirs(raw)
    # tests/test_datasets_raw.py:194-207's fixture: 30 papers, 8 features
    rng = np.random.default_rng(0)
    n = 30
    lines = ["\t".join([f"p{i}"] + [str(v) for v in rng.integers(0, 2, 8)]
                       + [f"class{i % 3}"]) for i in range(n)]
    with open(os.path.join(raw, "cora.content"), "w") as f:
        f.write("\n".join(lines) + "\n")
    cites = [f"p{rng.integers(0, n)}\tp{rng.integers(0, n)}"
             for _ in range(80)]
    with open(os.path.join(raw, "cora.cites"), "w") as f:
        f.write("\n".join(cites) + "\n")
    out = {}
    for key, argv in [("cora", ["--only", "_cora", "--steps", "30"])] + [
            (name, ["--only", name, "--steps", "5", "--allow-synthetic"])
            for name in PARITY_OTHER_ROWS]:
        summary = parity_run.main(argv + [
            "--data_dir", os.path.join(root, "data"), "--model_dir",
            os.path.join(root, "models"), "--json",
            os.path.join(root, f"parity_{key}.json")])
        check(summary["errors"] == 0 and summary["skipped"] == 0
              and summary["ran"] == (15 if key == "cora" else 1),
              f"parity {key}: {summary}")
        if key == "cora":
            check(all(r["status"] == "ran" and r["delta"] is not None
                      and math.isfinite(r["value"])
                      for r in summary["results"]),
                  f"parity cora rows {summary}")
        out[key] = summary
    out["seconds"] = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    log(f"tools parity: {json.dumps(out)}; {smi}")
    return out


def phase_tools(dev, smi: str, link_bytes_per_s: float) -> dict:
    """Phase 16: the tools (see the module docstring)."""
    t0 = time.perf_counter()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(TOOLS_DIR)
    out = dict(bench=tools_bench(dev, smi))
    torch.cuda.empty_cache()
    out["suite"] = tools_suite(smi)
    out["scaling"] = tools_scaling(link_bytes_per_s, smi)
    out["drill"] = tools_drill(smi)
    out["parity"] = tools_parity(smi)
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log(f"tools phase: {out['seconds']:.1f} s (bench "
        f"{out['bench']['plain']['seconds']:.1f} + "
        f"{out['bench']['dedup']['seconds']:.1f}, suite "
        f"{out['suite']['seconds']:.1f}, scaling "
        f"{out['scaling']['seconds']:.1f}, drill "
        f"{out['drill']['seconds']:.1f}, parity "
        f"{out['parity']['seconds']:.1f}); {smi}")
    return out


# --------------------------------------------------------------- phase 17 --

GRAFT_WORLD, GRAFT_TIMED, GRAFT_WIDTH = 4, 20, 1000


def graft_perms(S: int) -> dict:
    """The probe's ppermute cases, (src, dst) pairs of the world's ranks:
    a cycle, and on 4 ranks one where rank 3 sends and gets nothing and
    rank 2 only receives."""
    perms = {"cycle": [(i, (i + 1) % S) for i in range(S)]}
    if S == 4:
        perms["partial"] = [(0, 2), (3, 1), (1, 0)]
    return perms


def graft_probe(run_step) -> dict:
    """Phase 17's probe in each rank of ``dryrun_multichip``: one more
    sage step with each launch held against its plain version
    (``tools_probe``), then ``comms.ppermute`` of a row a rank on the card
    over the world's ranks (``graft_perms``), forward and backward, its
    bytes counted."""
    out = tools_probe(run_step)
    S, r = dist.get_world_size(), dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    out["ppermute"] = {}
    for name, perm in graft_perms(S).items():
        x = (torch.arange(GRAFT_WIDTH, dtype=torch.float32, device=dev)
             + 1e4 * (r + 1)).requires_grad_(True)
        c = torch.full((GRAFT_WIDTH,), float(r + 1), device=dev)
        with comms.account() as acc:
            y = comms.ppermute(x, dist.group.WORLD, perm)
            (y * c).sum().backward()
        torch.cuda.synchronize()
        out["ppermute"][name] = dict(
            y=y.detach().cpu().numpy(), grad=x.grad.cpu().numpy(),
            forward=acc.totals(comms.FORWARD)["ppermute"],
            backward=acc.totals(comms.BACKWARD)["ppermute"])
    return out


def graft_check_ppermute(ranks: list, tag: str) -> dict:
    """Each rank's ppermute results against the same permutation of the
    rows on the host: y[dst] = x[src] and grad[src] = c[dst], zeros where
    no pair reads or writes, bit for bit; n bytes each way."""
    S = len(ranks)
    x = [np.arange(GRAFT_WIDTH, dtype=np.float32) + np.float32(1e4 * (r + 1))
         for r in range(S)]
    out = {}
    for name, perm in graft_perms(S).items():
        y = [np.zeros(GRAFT_WIDTH, np.float32) for _ in range(S)]
        grad = [np.zeros(GRAFT_WIDTH, np.float32) for _ in range(S)]
        for src, dst in perm:
            y[dst] = x[src]
            grad[src] = np.full(GRAFT_WIDTH, dst + 1, np.float32)
        for r, res in enumerate(ranks):
            got = res["probe"]["ppermute"][name]
            check(np.array_equal(got["y"], y[r])
                  and np.array_equal(got["grad"], grad[r]),
                  f"graft {tag} rank {r}: ppermute {name} != the host's")
            check(got["forward"] == got["backward"] == 4 * GRAFT_WIDTH,
                  f"graft {tag} rank {r}: ppermute bytes {got}")
        out[name] = dict(pairs=len(perm), bytes=4 * GRAFT_WIDTH,
                         ranks=S)
    return out


def graft_entry_forward(dev) -> dict:
    """entry()'s forward on the card: 2 + 2 launches, each equal to its
    plain version, and timed at its shape; the loss and logit against the
    same forward on the CPU (the same weights, the card's uniforms)
    within 1e-4; ms a forward (CUDA-event median of GRAFT_TIMED)."""
    fn, (model, g, roots, uniforms) = graft_entry.entry()
    fn_cpu, (model_cpu, g_cpu, roots_cpu, _) = graft_entry.entry("cpu")
    state, state_cpu = model.state_dict(), model_cpu.state_dict()
    check(all(torch.equal(state[k].cpu(), state_cpu[k]) for k in state),
          "entry: the card's weights != the CPU's")
    reset_counts()
    with torch.no_grad(), KernelRecorder(eager=True) as rec:
        loss, logit = fn(model, g, roots, uniforms)
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches == kernel_counts(fan_draw=2, gather_rows=2,
                                    sigmoid_xent=HEAD_BATCH),
          f"entry: launches {launches}")
    checked = rec.check_plain("entry forward")
    u_cpu = [tuple(u.cpu() for u in hop) for hop in uniforms]
    with torch.no_grad():
        loss_cpu, logit_cpu = fn_cpu(model_cpu, g_cpu, roots_cpu, u_cpu)
    check(logit.shape == (graft_entry.ROOTS, 4)
          and torch.isfinite(logit).all().item(), "entry: logit")
    err = max(float((logit.cpu() - logit_cpu).abs().max()),
              abs(float(loss) - float(loss_cpu)))
    check(torch.allclose(logit.cpu(), logit_cpu, **PARITY_TOL)
          and math.isclose(float(loss), float(loss_cpu),
                           rel_tol=1e-4, abs_tol=1e-4),
          f"entry: card != CPU by {err}")
    with torch.no_grad():
        ms = [cuda_ms(lambda: fn(model, g, roots, uniforms))
              for _ in range(GRAFT_TIMED)]
    out = dict(loss=float(loss), loss_cpu=float(loss_cpu), max_abs_err=err,
               launches=launches, checked_plain=checked,
               forward_ms=statistics.median(ms),
               kernels=mesh_kernel_times(rec.calls, dev, "entry"))
    log(f"entry forward: {json.dumps(out)}")
    return out


def graft_dryrun(n: int, backend: str, smi: str) -> dict:
    """dryrun_multichip(n) over ``backend`` with ``graft_probe``: on
    every rank the first step's 2 + 2 launches, the probed step's held
    against their plain versions, none in the DeepWalk step, finite
    losses, the forward bytes equal on every rank; ppermute checked."""
    t0 = time.perf_counter()
    res = graft_entry.dryrun_multichip(n, backend=backend,
                                       probe=graft_probe)
    seconds = time.perf_counter() - t0
    tag = f"{backend}{n}"
    ranks = res["ranks"]
    for r in ranks:
        want = kernel_counts(fan_draw=2, gather_rows=2,
                             sigmoid_xent=HEAD_STEP)
        check(r["launches"] == want and r["probe"]["launches"] == want
              and r["probe"]["checked"] == want
              and r["loop_launches"] == kernel_counts(
                  fan_draw=4, gather_rows=4, sigmoid_xent=2 * HEAD_STEP)
              and r["walk_launches"] == kernel_counts(),
              f"graft {tag} rank {r['rank']}: launches {r['launches']}, "
              f"{r['loop_launches']}, {r['walk_launches']}, probe "
              f"{r['probe']['launches']}")
        check(all(math.isfinite(r[k]) for k in ("first_loss", "loss",
                                                   "walk_loss")),
              f"graft {tag} rank {r['rank']}: losses")
        check(r["forward"] == ranks[0]["forward"],
              f"graft {tag} rank {r['rank']}: bytes {r['forward']} != rank "
              f"0's {ranks[0]['forward']}")
    out = dict(mesh=res["mesh"], loss=res["loss"],
               first_loss=ranks[0]["first_loss"], walk_loss=res["walk_loss"],
               seconds=seconds, forward=ranks[0]["forward"],
               backward=ranks[0]["backward"],
               step_ms=[r["step_ms"] for r in ranks],
               rank_seconds=[r["seconds"] for r in ranks],
               launches=[r["launches"] for r in ranks],
               probe_launches=[r["probe"]["launches"] for r in ranks],
               ppermute=graft_check_ppermute(ranks, tag))
    log(f"graft dryrun {tag}: {json.dumps(out)}; {smi}")
    return out


def phase_graft(dev, smi: str) -> dict:
    """Phase 17: the driver's entry points (see the module docstring)."""
    t0 = time.perf_counter()
    out = dict(entry=graft_entry_forward(dev))
    out["nccl"] = graft_dryrun(1, "nccl", smi)
    out["gloo"] = graft_dryrun(GRAFT_WORLD, "gloo", smi)
    check(out["gloo"]["mesh"] == graft_entry.pick_mesh(GRAFT_WORLD),
          f"graft: mesh {out['gloo']['mesh']}")
    out["seconds"] = time.perf_counter() - t0
    log(f"graft phase: {out['seconds']:.1f} s; {smi}")
    return out


# ------------------------------------------------------------------- main --

def ptxas_report(name: str, package_dir: str = PACKAGE_DIR) -> dict:
    """Build csrc/<name>.cu of ``package_dir`` (this checkout's package by
    default) once more with ``-Xptxas -v`` into a scratch directory:
    mangled kernel name -> registers, static shared memory and spill
    bytes."""
    src = os.path.join(package_dir, "csrc", f"{name}.cu")
    with tempfile.TemporaryDirectory() as tmp:
        err = subprocess.run(
            [nvcc()] + NVCC_FLAGS + ["-Xptxas", "-v", src, "-o",
                                     os.path.join(tmp, "lib.so")],
            check=True, capture_output=True, text=True, timeout=600).stderr
    report, fn = {}, None
    for line in err.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            report[fn] = {}
        elif fn is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                report[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                smem = re.search(r"(\d+) bytes smem", line)
                report[fn].update(registers=int(m.group(1)),
                                  static_smem_bytes=int(smem.group(1))
                                  if smem else 0)
    return report


# ------------------------------------------------------------ phase 12r --

def rgcn_cell_layer(graph, F: int, dev, seed: int = 26):
    """The first layer's operands at the rgcn-train cell's shapes, laid as
    ``dataflow.block._RelConv`` lays them: per row range of the plan a
    [rows, (k + 1) F] f32 GEMM output whose first k F columns, rounded to
    bf16, are its edge types' message rows and whose last F the root's;
    the cotangent [N, F] bf16; the transpose's f32 gradient tables."""
    g, p = graph.tensors, graph.tensors.rel
    R = len(p.row_lo)
    blk = WholeDataFlow(1, [tuple(range(R))], add_self_loops=False,
                        layout="rel")(g, torch.arange(1, device=dev))[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows, roots, grads = [None] * R, [None] * (len(p.type_lo) - 1), [None] * R
    for lo, hi, rels, k in blk.rel.plan(p.type_lo):
        z = torch.randn((hi - lo, (len(rels) + 1) * F), generator=gen,
                        device=dev)
        m = z[:, :len(rels) * F].to(torch.bfloat16)
        dz = torch.empty_like(z)
        for q, r in enumerate(rels):
            rows[r] = m[:, q * F:(q + 1) * F]
            grads[r] = dz[:, q * F:(q + 1) * F]
        if k >= 0:
            roots[k] = z[:, len(rels) * F:]
    cot = torch.randn((graph.meta.n_nodes, F), generator=gen,
                      device=dev).to(torch.bfloat16)
    return blk.rel.mask, rows, roots, grads, cot


def phase_rgcn(dev) -> dict:
    """At the rgcn-train cell's shapes (the graph of
    benchmark/configs/rgcn.json, drawn and built by its configuration
    module; F = 64 bf16 messages as the first layer lays them,
    ``rgcn_cell_layer``): the typed mean kernel and its transpose each
    held to its plain version on CPU copies (largest gap over the plain
    version's largest magnitude), the same bits on a second call, then
    timed with CUDA events, L2 flushed, beside its bytes bound
    (``rgcn_arith.call_bytes``) and the library yardstick: one
    ``torch.sparse.mm`` of the CSR [N, R N] of weights 1 / c(t, r) by the
    messages stacked a relation at a time, f32 (forward only)."""
    from benchmark.harness.arith import PEAKS
    from benchmark.harness.rgcn_arith import call_bytes
    from benchmark.harness.spec import Spec
    spec = Spec()
    cfg = spec.config("rgcn")
    mod = spec.config_module("rgcn")
    t0 = time.perf_counter()
    arrays = mod.graph_arrays(cfg["graph"])
    t1 = time.perf_counter()
    graph = mod.program_graph(cfg, arrays, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"rgcn cell graph: edge arrays {t1 - t0:.1f} s, program graph "
        f"{t2 - t1:.1f} s; " + mod.degree_report(cfg["graph"], arrays))
    g, p = graph.tensors, graph.tensors.rel
    F = cfg["model"]["dims"][0]
    mask, rows, roots, grads, cot = rgcn_cell_layer(graph, F, dev)

    def fwd():
        return rel_agg.rel_mean(rows, p.row_lo, g.group_ptr, g.adj_dst, roots,
                                p.type_lo, mask, p.hubs)

    def tr():
        rel_agg.rel_mean_tr(cot, p.tptr, p.tsrc, p.tw, grads, p.row_lo,
                            mask, p.tr_hubs)
    out = fwd()
    check(torch.equal(out, fwd()), "rgcn forward: the same bits twice")
    tr()
    first = [v.clone() for v in grads if v is not None]
    tr()
    check(all(torch.equal(a, b) for a, b in
              zip(first, [v for v in grads if v is not None])),
          "rgcn transpose: the same bits twice")
    cpu = [None if v is None else v.cpu() for v in rows]
    plain = rel_agg.rel_mean_plain(
        cpu, p.row_lo, g.group_ptr.cpu(), g.adj_dst.cpu(),
        [None if v is None else v.cpu() for v in roots], p.type_lo, mask)
    fwd_gap = float((out.cpu() - plain).abs().max() / plain.abs().max())
    tr_plain = [None if v is None else torch.empty(v.shape) for v in grads]
    rel_agg.rel_mean_tr_plain(cot.cpu(), p.tptr.cpu(), p.tsrc.cpu(),
                              p.tw.cpu(), tr_plain, p.row_lo, mask)
    tr_gap = max(float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(
        1e-30)) for a, b in zip(grads, tr_plain) if a is not None)
    check(fwd_gap < RGCN_TOL and tr_gap < RGCN_TOL,
          f"rgcn kernels against their plain versions: {fwd_gap:.3g}, "
          f"{tr_gap:.3g}")
    del plain, tr_plain, cpu
    # the library yardstick: the weighted CSR [N, R N] by every relation's
    # messages stacked [R N, F] (zero rows outside a relation's range)
    n, R = graph.meta.n_nodes, len(p.row_lo)
    cnt = (g.group_ptr[1:] - g.group_ptr[:-1]).float()
    seg = torch.repeat_interleave(torch.arange(n * R, device=dev),
                                  (g.group_ptr[1:] - g.group_ptr[:-1]).long())
    col = (seg % R) * n + g.adj_dst.long()
    a = torch.sparse_csr_tensor(
        (g.group_ptr.long()[::R]).contiguous(), col,
        1.0 / cnt[seg], size=(n, R * n))
    stacked = torch.zeros((R * n, F), device=dev)
    for r, v in enumerate(rows):
        if v is not None:
            stacked[r * n + p.row_lo[r]:r * n + p.row_hi[r]] = v.float()
    lib_out = torch.sparse.mm(a, stacked)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    res = dict(fwd_ms=time_launches(fwd, 50, flush),
               tr_ms=time_launches(tr, 50, flush),
               sparse_mm_ms=time_launches(lambda: torch.sparse.mm(a, stacked),
                                          20, flush),
               fwd_gap=fwd_gap, tr_gap=tr_gap,
               bound_fwd_ms=call_bytes(cfg, False, 2)
               / PEAKS["hbm_bytes_per_s"] * 1e3,
               bound_tr_ms=call_bytes(cfg, True, 2)
               / PEAKS["hbm_bytes_per_s"] * 1e3,
               hub_chunks=[int(p.hubs.chunks.shape[0]),
                           int(p.tr_hubs.chunks.shape[0])],
               graph_s=[t1 - t0, t2 - t1])
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fwd()
            tr()
        torch.cuda.synchronize()
    res["kernel_ms"] = {e.key[:60]: e.device_time_total / 5e3
                        for e in prof.key_averages()
                        if "rel_mean" in e.key}
    for k, v in enumerate(roots):
        if v is not None:
            lib_out[p.type_lo[k]:p.type_lo[k + 1]] += v
    res["sparse_mm_gap"] = float((lib_out - out).abs().max()
                                 / out.abs().max())
    log(f"rgcn kernels: {json.dumps(res)}")
    return res


# ------------------------------------------------------------ phase 12s --

def phase_xent(dev) -> dict:
    """SuperviseModel's loss kernels (``ops.sigmoid_xent``) at the
    rgcn-train cell's shape (benchmark/configs/rgcn.json: its roots by its
    classes; f32 logits from a seed, every 97th row exactly 0, one-hot f32
    labels, every root valid): the loss and the gradient held to the
    torch chain they replace (``_sigmoid_xent(x, y) * valid`` summed,
    under autograd: the forward's plain version) and the gradient to its
    plain version on the card (XENT_TOL),
    -g y where a logit is 0, the same bits on a second call; then each
    timed with CUDA events, L2 flushed, beside its bytes bound (the
    forward reads the logits and labels, the backward reads them and
    writes the gradient) and beside the chain's forward and backward."""
    from benchmark.harness.arith import PEAKS
    from benchmark.harness.spec import Spec
    cfg = Spec().config("rgcn")
    R, C = cfg["train"]["batch"], cfg["data"]["classes"]
    gen = torch.Generator(device=dev).manual_seed(27)
    x = torch.randn((R, C), generator=gen, device=dev) * 2
    x[::97] = 0.0
    cls = torch.randint(0, C, (R,), generator=gen, device=dev)
    y = torch.nn.functional.one_hot(cls, C).float()
    v = torch.ones(R, device=dev)
    up = torch.ones((), device=dev)

    def fwd():
        return xent_ops.sigmoid_xent(x, y, v)

    def bwd():
        return xent_ops.sigmoid_xent_grad(x, y, v, den, up)
    loss, den = fwd()
    again = fwd()
    d = bwd()
    check(torch.equal(loss, again[0]) and torch.equal(den, again[1])
          and torch.equal(d, bwd()), "xent kernels: the same bits twice")
    xr = x.clone().requires_grad_()

    def chain():
        return (gnn_models._sigmoid_xent(xr, y) * v[:, None]).sum() / (
            v.sum() * C).clamp_min(1.0)
    ref = chain()
    (ref_grad,) = torch.autograd.grad(ref, xr, retain_graph=True)
    _, plain_den = xent_ops.sigmoid_xent_plain(x, y, v)
    plain_grad = xent_ops.sigmoid_xent_grad_plain(x, y, v, den, up)
    tie = (-(up / den) * v[:, None] * y)[::97]
    res = dict(R=R, C=C, loss=float(loss), chain_loss=float(ref),
               loss_gap=xent_gap(loss, ref.detach()),
               grad_gap=xent_gap(d, ref_grad),
               plain_grad_gap=xent_gap(d, plain_grad),
               grad_equals_plain=bool(torch.equal(d, plain_grad)),
               tie_gap=xent_gap(d[::97], tie))
    check(float(den) == float(plain_den), f"xent den {float(den)} against "
          f"{float(plain_den)}")
    check(max(res["loss_gap"], res["grad_gap"], res["plain_grad_gap"],
              res["tie_gap"]) <= XENT_TOL,
          f"xent kernels against the chain and their plain versions: {res}")
    del ref_grad, plain_grad, tie
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    res.update(
        fwd_ms=time_launches(fwd, 50, flush),
        bwd_ms=time_launches(bwd, 50, flush),
        chain_fwd_ms=time_launches(chain, 10, flush),
        chain_bwd_ms=time_launches(lambda: torch.autograd.grad(
            ref, xr, retain_graph=True), 10, flush),
        bound_fwd_ms=2 * R * C * 4 / PEAKS["hbm_bytes_per_s"] * 1e3,
        bound_bwd_ms=3 * R * C * 4 / PEAKS["hbm_bytes_per_s"] * 1e3)
    res["fwd_roofline"] = 100 * res["bound_fwd_ms"] / res["fwd_ms"]
    res["bwd_roofline"] = 100 * res["bound_bwd_ms"] / res["bwd_ms"]
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fwd()
            bwd()
        torch.cuda.synchronize()
    res["kernel_ms"] = {e.key[:60]: e.device_time_total / 5e3
                        for e in prof.key_averages() if "xent" in e.key}
    log(f"xent kernels: {json.dumps(res)}")
    return res


# --------------------------------------------------------------- phase 14 --

# the mesh phase: the sage graph over MESH_SHARDS graph shards, one gloo
# rank a shard on the one card, BATCH roots a rank; then one NCCL rank
# over the whole graph as one shard
MESH_SHARDS, MESH_BATCHES, MESH_TIMEOUT_S = 4, 20, 600
MESH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "mesh14")


def rank_mesh(data: int, graph: int, backend: str, spawned: float):
    """A rank's start under ``launch`` (the process group joined): only
    rank 0 prints, TF32 off, the mesh on card 0. Returns (mesh, the
    perf_counter at the start, the seconds since ``spawned``: the
    parent's wall clock when it started the ranks)."""
    if dist.get_rank():
        sys.stdout = open(os.devnull, "w")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    start_s = time.time() - spawned
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = mesh_lib.make_mesh(data, graph, backend=backend, device=dev,
                              timeout_s=MESH_TIMEOUT_S)
    return mesh, t0, start_s


def mesh_rank(work: str, tag: str, data: int, graph: int, backend: str,
              shards: str, spawned: float) -> dict:
    """One gloo rank of phase 14, started by ``launch``: load this rank's
    shard onto the card and ``mesh_serve``; only rank 0 prints.
    ``spawned``: the parent's wall clock when it started the ranks."""
    mesh, t0, start_s = rank_mesh(data, graph, backend, spawned)
    view = sharded.load_shard(shards, mesh.graph_index, mesh.device, mesh)
    return mesh_serve(work, tag, mesh, view, t0, start_s)


def mesh_serve(work: str, tag: str, mesh, view, t0: float,
               start_s: float = 0.0) -> dict:
    """One rank's part of phase 14 over its ``view``: hold one sharded
    apply of the parent's U_all against the parent's one-card forward
    (embeddings and logits equal) with each kernel launch against its
    plain version and 2 + 2 launches, account one batch's collectives
    (bytes and calls), time MESH_BATCHES batches (CUDA events), profile
    one and list the host ops of another; rank 0 then times each kernel
    at the shapes it launched while the others wait. ``stages_s``: the
    seconds from the spawn to the rank's start (``start_s``, 0 in the
    parent), to the shard on the card, and of each part after. Returns
    the rank's results."""
    rank, backend, dev = mesh.rank, mesh.backend, view.device
    model = bench.make_model("sage", dev,
                             generator=torch.Generator().manual_seed(0))
    model.load_state_dict(torch.load(os.path.join(work, "model.pt"),
                                     map_location=dev))
    apply = sharded_train.make_sharded_apply(model, mesh)
    with np.load(os.path.join(work, f"inputs_{tag}.npz")) as z:
        batch = torch.from_numpy(z["batch"]).to(dev)
        u_all = [tuple(torch.from_numpy(z[f"h{h}_u{i}"]).to(dev)
                       for i in range(2)) for h in range(len(FANOUTS))]
        want = {k: torch.from_numpy(z[k]).to(dev)
                for k in ("embedding", "logit")}
    res = dict(rank=rank, backend=backend, ready_s=time.perf_counter() - t0)
    stages = dict(start=start_s, ready=res["ready_s"])
    t_stage = time.perf_counter()

    def stage(name):
        nonlocal t_stage
        stages[name] = time.perf_counter() - t_stage
        t_stage = time.perf_counter()
    rec = KernelRecorder(eager=True)
    reset_counts()
    with rec:
        out = apply(view, batch, uniforms=u_all)
    torch.cuda.synchronize()
    res["launches"] = read_counts()
    check(res["launches"] == kernel_counts(fan_draw=2, gather_rows=2,
                                           sigmoid_xent=HEAD_BATCH),
          f"mesh rank {rank}: launches {res['launches']}, want 2 + 2 + 1")
    res["checked_plain"] = rec.check_plain(f"mesh rank {rank}")
    res["max_abs_err"] = {k: float((out[k] - want[k]).abs().max())
                          for k in want}
    for k in want:
        check(torch.equal(out[k], want[k]),
              f"mesh rank {rank}: {k} != the one-card forward")
    check(out["embedding"].shape == (batch.shape[0], DIMS[-1])
          and bool(torch.isfinite(out["embedding"]).all()),
          f"mesh rank {rank}: embeddings not finite [B, D]")
    stage("checked")
    with comms.account() as acc:
        apply(view, batch, seed=0)
    res["bytes_per_batch"] = acc.totals()
    res["collective_calls_per_batch"] = {
        k: sum(1 for e in acc.events if e[0] == k) for k in sorted(
            {e[0] for e in acc.events})}
    reset_counts()
    ms = []
    for i in range(MESH_BATCHES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        o = apply(view, batch, seed=1 + i)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        check(bool(torch.isfinite(o["logit"]).all()),
              f"mesh rank {rank}: logits not finite")
    res["batch_ms"] = ms
    res["batch_ms_median"] = statistics.median(ms)
    res["timed_launches"] = read_counts()
    check(res["timed_launches"] == kernel_counts(
              fan_draw=2 * MESH_BATCHES, gather_rows=2 * MESH_BATCHES,
              sigmoid_xent=HEAD_BATCH * MESH_BATCHES),
          f"mesh rank {rank}: {res['timed_launches']} in {MESH_BATCHES} "
          f"batches")
    stage("timed")

    def one_batch():
        apply(view, batch, seed=99)
    if rank == 0:
        prof = profile(one_batch, f"one sharded batch ({backend})",
                       attempts=1)
        res["profile"] = {k: prof[k] for k in (
            "host_ms", "device_busy_ms", "device_idle_share",
            "kernel_events_complete", "traced", "launched")}
        check(prof["kernel_events_complete"],
              f"mesh rank 0: the trace holds {prof['traced']} of "
              f"{prof['launched']}")
        res["host_ops"] = host_ops(one_batch,
                                   f"one sharded batch ({backend})")
    else:
        one_batch()
        one_batch()
    torch.cuda.synchronize()
    stage("profiled")
    if rank == 0:
        res["kernels"] = mesh_kernel_times(rec.calls, dev)
    stage("kernels")
    dist.barrier(group=mesh.world_group)
    stage("barrier")
    res["stages_s"] = stages
    return res


def mesh_kernel_times(calls, dev, what: str = "mesh") -> list:
    """Each kernel launch of one sharded batch on rank 0 (or of one
    recorded step), timed at its shape (CUDA-event medians, L2 flushed)
    beside its plain version, its bytes bound and, for the gather,
    torch.index_select."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for name, args, kwargs, _ in calls:
        if name.startswith("sigmoid_xent"):
            continue                          # the loss: phase 12s times it
        if name == "fan_draw":
            pack, nodes, u1, u2 = args[0], args[1], args[4], args[5]
            row = dict(name=name, B=u1.shape[0], C=u1.shape[1],
                       live=int((nodes >= 0).sum()),
                       bytes=needed_bytes(pack, nodes, u1, u2))
            row["ms"] = time_launches(lambda: fd.fan_draw(*args, **kwargs),
                                      200, flush)
            row["plain_ms"] = time_launches(
                lambda: fd.fan_draw_plain(*args, **kwargs), 50, flush)
            row["library_ms"] = None
        else:
            table, ids = args[0], args[1]
            clamped = ids.long().clamp(0, table.shape[0] - 1)
            row = dict(name=name, N=table.shape[0], D=table.shape[1],
                       M=ids.shape[0], live=int((ids >= 0).sum()),
                       bytes=gather_bytes(table, ids))
            row["ms"] = time_launches(lambda: gr.gather_rows(table, ids),
                                      200, flush)
            row["plain_ms"] = time_launches(
                lambda: gr.gather_rows_plain(table, ids), 50, flush)
            row["library_ms"] = time_launches(
                lambda: torch.index_select(table, 0, clamped), 200, flush)
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        rows.append(row)
        log(f"{what} kernel: {json.dumps(row)}")
    return rows


def mesh_inputs(tag: str, batch: np.ndarray, per_rank: list, embs, logits,
                groups) -> None:
    """The inputs of one mesh run: the whole batch, each hop's U_all (the
    concatenation of the group members' uniforms, in member order) and
    the one-card forward's embeddings and logits of the whole batch."""
    arrays = dict(batch=batch, embedding=torch.cat(embs).cpu().numpy(),
                  logit=torch.cat(logits).cpu().numpy())
    for h in range(len(FANOUTS)):
        for i in range(2):
            arrays[f"h{h}_u{i}"] = torch.cat(
                [per_rank[r][h][i] for r in groups]).cpu().numpy()
    np.savez(os.path.join(MESH_DIR, f"inputs_{tag}.npz"), **arrays)


def adopt_shard_reservoirs(g, sg) -> int:
    """Check that each shard's fan rows equal the one-card pack's rows of
    the same (node, type) groups, but for the reservoir rows (groups of
    degree > FAN_D), which each shard draws with a generator of its own;
    then write those into the one-card pack, so that both hold the same
    draws. Returns the rows written."""
    S, ET = sg.num_shards, sg.meta.num_edge_types
    written = 0
    for s in range(S):
        n_local = len(range(s, sg.meta.n_nodes, S))
        local = torch.from_numpy(sg.fan_pack[s][: n_local * ET]).to(g.device)
        glob = ((torch.arange(n_local, device=g.device)[:, None] * S + s)
                * ET + torch.arange(ET, device=g.device)).reshape(-1)
        res = torch.from_numpy(np.diff(sg.group_ptr[s])[: n_local * ET]
                               > FAN_D).to(g.device)
        check(torch.equal(g.fan_pack[glob[~res]], local[~res]),
              f"mesh: shard {s}'s fan rows != the one-card pack's")
        g.fan_pack[glob[res]] = local[res]
        written += int(res.sum())
    return written


def phase_mesh(graph, model, dev, smi: str) -> tuple:
    """Phase 14: sharded sage serving over torch.distributed. Returns its
    results and the host's shards (4 and 1), whose files under MESH_DIR
    phase 15 reads; the caller removes them."""
    t_phase = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    t0 = time.perf_counter()
    sgs = {S: sharded.build_sharded(graph, S) for S in (MESH_SHARDS, 1)}
    sharded.write_shards(sgs[MESH_SHARDS],
                         os.path.join(MESH_DIR, f"shards{MESH_SHARDS}"))
    out = dict(shard_host_s=time.perf_counter() - t0)
    torch.save(model.state_dict(), os.path.join(MESH_DIR, "model.pt"))
    # the one-card forward of each rank's roots from its own uniforms:
    # rank 0's on the one shard's reservoir rows (the NCCL rank's), then
    # every rank's on the 4 shards', each adopted by the one-card pack
    rng = np.random.default_rng(14)
    batch = rng.integers(0, N_NODES, MESH_SHARDS * BATCH).astype(np.int32)
    flow, g = model.embedder.flow, graph.tensors
    gen = torch.Generator(device=dev).manual_seed(14)
    roots_of = [torch.from_numpy(batch[r * BATCH:(r + 1) * BATCH]).to(dev)
                for r in range(MESH_SHARDS)]
    per_rank = [hop_uniforms(flow, g, roots, gen) for roots in roots_of]
    model.eval()
    with torch.no_grad():
        out["reservoir_rows_adopted"] = [adopt_shard_reservoirs(g, sgs[1])]
        one = model(g, roots_of[0], uniforms=per_rank[0])
        out["reservoir_rows_adopted"].append(adopt_shard_reservoirs(
            g, sgs[MESH_SHARDS]))
        embs, logits = [], []
        for roots, u in zip(roots_of, per_rank):
            o = model(g, roots, uniforms=u)
            embs.append(o["embedding"])
            logits.append(o["logit"])
        ms = []
        roots = torch.from_numpy(batch[:BATCH]).to(dev)
        for i in range(MESH_BATCHES):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model(g, roots, generator=gen)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        out["single_card_host_ops"] = host_ops(
            lambda: model(g, roots, generator=gen), "one-card forward")
    out["single_card_batch_ms_median"] = statistics.median(ms)
    mesh_inputs("gloo", batch, per_rank, embs, logits,
                range(MESH_SHARDS))
    mesh_inputs("nccl", batch[:BATCH], per_rank[:1], [one["embedding"]],
                [one["logit"]], range(1))
    t0 = time.perf_counter()
    out["gloo"] = launcher.launch(
        mesh_rank, MESH_SHARDS, "gloo", MESH_TIMEOUT_S,
        args=(MESH_DIR, "gloo", 1, MESH_SHARDS, "gloo",
              os.path.join(MESH_DIR, f"shards{MESH_SHARDS}"), time.time()))
    out["gloo_s"] = time.perf_counter() - t0
    # the one-rank NCCL group in this process, over the one shard
    t0 = time.perf_counter()
    mesh = mesh_lib.make_mesh(
        1, 1, backend="nccl", device=torch.device("cuda", 0),
        init_method="file://" + os.path.join(MESH_DIR, "rendezvous_nccl"),
        rank=0, timeout_s=MESH_TIMEOUT_S)
    try:
        out["nccl"] = [mesh_serve(
            MESH_DIR, "nccl", mesh,
            sharded.take_shard(sgs[1], 0, mesh.device, mesh), t0)]
    finally:
        mesh_lib.close()
    out["nccl_s"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    for tag in ("gloo", "nccl"):
        for res in out[tag]:
            log(f"mesh {tag} rank {res['rank']}: "
                f"{res['batch_ms_median']:.4f} ms per sharded infer batch "
                f"(CUDA-event median of {MESH_BATCHES}); {smi}")
        log(f"mesh {tag} rank 0 bytes per batch: "
            f"{json.dumps(out[tag][0]['bytes_per_batch'])}; collective "
            f"calls per batch: "
            f"{json.dumps(out[tag][0]['collective_calls_per_batch'])}; "
            f"{smi}")
        for res in out[tag]:
            log(f"mesh {tag} rank {res['rank']} stages (s): "
                f"{json.dumps(res['stages_s'])}")
    log(f"mesh single card: {out['single_card_batch_ms_median']:.4f} ms per "
        f"infer batch of {BATCH} roots (CUDA-event median of "
        f"{MESH_BATCHES}); {smi}")
    log(f"mesh phase: {out['seconds']:.1f} s (shards on the host "
        f"{out['shard_host_s']:.1f} s, gloo ranks {out['gloo_s']:.1f} s, "
        f"the nccl group {out['nccl_s']:.1f} s); {smi}")
    return out, sgs


# phase 15: training over the mesh. Sage steps at 1024 roots a rank on the
# shards of phase 14 (4 gloo ranks, then one NCCL rank), a few steps of
# SpmdNodeEstimator.train, TransE with its entity table split over 4 gloo
# ranks at the transe graph's width (1024 triples a rank) and gcn over
# psum blocks on a 10,000-node graph
MESH_TRAIN_STEPS, MESH_TRAIN_TIMED, MESH_EST_STEPS = 3, 10, 4
MESH_TRAIN_LR = 1e-3
MESH_TRAIN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "build", "mesh15")
MESH_TRANSE_BATCH, MESH_GCN_NODES, MESH_GCN_ROOTS = 1024, 10_000, 256


class GradRecorder(torch.optim.Optimizer):
    """An optimizer whose step keeps each parameter's (synced) gradient by
    name and changes nothing."""

    def __init__(self, named):
        named = list(named)
        super().__init__([p for _, p in named], {})
        self.names, self.grads = [n for n, _ in named], {}

    def step(self, closure=None):
        params = [p for grp in self.param_groups for p in grp["params"]]
        self.grads = {n: p.grad.detach().clone()
                      for n, p in zip(self.names, params)}


def hop_owners(flow, roots_per_rank: int, world: int) -> list:
    """Per hop, the rank each row of the one-card draw over the
    concatenated roots belongs to (a hop's rows are the previous hop's,
    then each row's draws in its order)."""
    owner = [np.arange(world * roots_per_rank) // roots_per_rank]
    for c in flow.fanouts[:-1]:
        owner.append(np.concatenate([owner[-1], np.repeat(owner[-1], c)]))
    return owner


def owner_uniforms(U, owners, members) -> list:
    """Each hop's uniforms for an owner of the graph group ``members``:
    the members' rows of the one-card draw ``U``, in member order."""
    return [tuple(torch.cat([u[torch.from_numpy(own == m).to(u.device)]
                             for m in members]) for u in hop)
            for hop, own in zip(U, owners)]


def onecard_sage_steps(state, graph, dev, roots, U) -> tuple:
    """MESH_TRAIN_STEPS Adam steps of sage on one card over ``roots[t]``
    with the hop uniforms ``U[t]``: (losses, final state on the host, the
    CUDA-event median ms of MESH_TRAIN_TIMED more eager steps of rank 0's
    1024 roots from a generator, on a copy)."""
    model = bench.make_model("sage", dev,
                             generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state)
    est = NodeEstimator(model, graph, RunConfig(batch_size=len(roots[0])),
                        device=dev)
    opt = get_optimizer("adam", MESH_TRAIN_LR, model.parameters())
    losses = [float(est.step(opt, r, uniforms=u)) for r, u in zip(roots, U)]
    final = {k: v.cpu() for k, v in model.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(7)
    ms = [cuda_ms(lambda: est.step(opt, roots[0][:BATCH], generator=gen))
          for _ in range(MESH_TRAIN_TIMED)]
    return losses, final, statistics.median(ms)


def cuda_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def account_step(fn, link_bytes_per_s=None, step_s=None) -> dict:
    """One call's bytes by collective and direction, gloo's host copies
    apart, and its collective calls, from ``comms.account()``; with a
    measured link rate and the one-card step time, the efficiency the
    cost model predicts (no overlap)."""
    with comms.account() as acc:
        fn()
    torch.cuda.synchronize()
    calls = {}
    for kind, _size, _b, direction in acc.events:
        key = f"{kind}_{direction}"
        calls[key] = calls.get(key, 0) + 1
    out = dict(forward=acc.totals(comms.FORWARD),
               backward=acc.totals(comms.BACKWARD), calls=calls,
               table=acc.table())
    if link_bytes_per_s:
        out["predicted_efficiency"] = acc.predicted_efficiency(
            step_s, link_bytes_per_s)
    return out


def link_rate(mesh, dev, mib: int = 64) -> float:
    """Bytes a second of one psum of ``mib`` MiB over every rank, by the
    cost model's count (2 (S-1)/S of the tensor), gloo's host copies
    included; CUDA events around it. 0 for a group of one."""
    x = torch.ones(mib << 18, device=dev)
    comms.psum(x, mesh.world_group)                 # warm the transport
    ms = cuda_ms(lambda: comms.psum(x, mesh.world_group))
    S = mesh.size
    return 2 * (S - 1) / S * x.numel() * 4 / (ms / 1e3)


def mesh_train_rank(work: str, tag: str, data: int, graph: int,
                    backend: str, shards: str, spawned: float) -> dict:
    """One gloo rank of phase 15, started by ``launch``: load this rank's
    shards onto the card, ``mesh_train_serve``, then the TransE and gcn
    parts; only rank 0 prints. Returns the rank's results."""
    mesh, t0, start_s = rank_mesh(data, graph, backend, spawned)
    dev = mesh.device
    view = sharded.load_shard(shards, mesh.graph_index, dev, mesh)
    res = mesh_train_serve(work, tag, mesh, view, t0, start_s)
    res["transe"] = mesh_transe_rank(work, mesh, dev)
    res["gcn"] = mesh_gcn_rank(work, mesh, dev)
    dist.barrier(group=mesh.world_group)
    return res


def mesh_train_serve(work: str, tag: str, mesh, view, t0: float,
                     start_s: float = 0.0) -> dict:
    """One rank's sage training over its ``view``: MESH_TRAIN_STEPS steps
    of ``make_sharded_train_step`` from the parent's ids and each owner's
    uniforms (its group members' rows of the one-card draws), each with
    2 + 2 launches held against their plain versions and its loss equal
    to the one-card step's over the concatenated batch within 1e-4, the
    final parameters too; the state written for the parent's check that
    replicated parameters are bit-equal across ranks; one step's bytes by
    collective forward and backward; MESH_TRAIN_TIMED steps timed (CUDA
    events); rank 0 profiles one step and times each kernel at the shape
    it launched; then SpmdNodeEstimator.train of MESH_EST_STEPS steps (a
    reservoir redraw) with its launches."""
    rank, backend, dev = mesh.rank, mesh.backend, view.device
    model = bench.make_model("sage", dev,
                             generator=torch.Generator().manual_seed(0))
    model.load_state_dict(torch.load(os.path.join(work, "model.pt"),
                                     map_location=dev))
    sharded_train.init_sharded_params(model, mesh)
    opt = get_optimizer("adam", MESH_TRAIN_LR, model.parameters())
    step = sharded_train.make_sharded_train_step(model, opt, mesh, BATCH)
    with np.load(os.path.join(work, f"inputs_{tag}.npz")) as z:
        ids = [torch.from_numpy(z[f"t{t}_ids"]).to(dev)
               for t in range(MESH_TRAIN_STEPS)]
        U = [[tuple(torch.from_numpy(z[f"t{t}_h{h}_u{i}"]).to(dev)
                    for i in range(2)) for h in range(len(FANOUTS))]
             for t in range(MESH_TRAIN_STEPS)]
        want_losses, want_step_ms = z["losses"], z["step_ms"]
    want = torch.load(os.path.join(work, f"want_{tag}.pt"))
    res = dict(rank=rank, backend=backend, ready_s=time.perf_counter() - t0,
               start_s=start_s)
    rec = KernelRecorder(eager=True)
    losses, launches = [], []
    for t in range(MESH_TRAIN_STEPS):
        reset_counts()
        with rec:
            loss = step(view, ids=ids[t], uniforms=U[t])
        torch.cuda.synchronize()
        launches.append(read_counts())
        check(launches[-1] == kernel_counts(fan_draw=2, gather_rows=2,
                                            sigmoid_xent=HEAD_STEP),
              f"mesh train rank {rank}: launches {launches[-1]}")
        losses.append(float(loss))
    res["launches"] = launches[0]
    res["checked_plain"] = rec.check_plain(f"mesh train rank {rank}")
    res["loss_abs_err"] = float(np.abs(np.array(losses)
                                       - want_losses).max())
    check(np.allclose(losses, want_losses, **PARITY_TOL),
          f"mesh train rank {rank}: losses {losses} != one card "
          f"{want_losses.tolist()}")
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    res["param_abs_err"] = max(float((state[k] - want[k]).abs().max())
                               for k in want)
    for k in want:
        check(torch.allclose(state[k], want[k], **PARITY_TOL),
              f"mesh train rank {rank}: {k} != the one-card step's")
    torch.save(state, os.path.join(work, f"state_{tag}_{rank}.pt"))
    res["link_bytes_per_s"] = link_rate(mesh, dev)
    res["bytes_per_step"] = account_step(
        lambda: step(view, seed=100), res["link_bytes_per_s"],
        float(want_step_ms) / 1e3)
    reset_counts()
    ms = [cuda_ms(lambda i=i: step(view, seed=200 + i))
          for i in range(MESH_TRAIN_TIMED)]
    res["step_ms"], res["step_ms_median"] = ms, statistics.median(ms)
    res["timed_launches"] = read_counts()
    check(res["timed_launches"] == kernel_counts(
              fan_draw=2 * MESH_TRAIN_TIMED,
              gather_rows=2 * MESH_TRAIN_TIMED,
              sigmoid_xent=HEAD_STEP * MESH_TRAIN_TIMED),
          f"mesh train rank {rank}: {res['timed_launches']}")
    if rank == 0:
        prof = profile(lambda: step(view, seed=300),
                       f"one sharded train step ({backend})", attempts=1)
        res["profile"] = {k: prof[k] for k in (
            "host_ms", "device_busy_ms", "device_idle_share",
            "kernel_events_complete", "traced", "launched")}
        check(prof["kernel_events_complete"],
              f"mesh train rank 0: the trace holds {prof['traced']} of "
              f"{prof['launched']}")
        res["kernels"] = mesh_kernel_times(rec.calls[:4], dev)
    else:
        step(view, seed=300)
    torch.cuda.synchronize()
    est = SpmdNodeEstimator(model, view, RunConfig(
        batch_size=BATCH * mesh.size, total_steps=MESH_EST_STEPS,
        learning_rate=MESH_TRAIN_LR, log_steps=0, reservoir_refresh=2),
        mesh=mesh)
    reset_counts()
    t_est = time.perf_counter()
    out = est.train()
    torch.cuda.synchronize()
    res["estimator"] = dict(loss=out["loss"], launches=read_counts(),
                            seconds=time.perf_counter() - t_est)
    check(np.isfinite(out["loss"])
          and res["estimator"]["launches"] == kernel_counts(
              fan_draw=2 * MESH_EST_STEPS, gather_rows=2 * MESH_EST_STEPS,
              sigmoid_xent=HEAD_STEP * MESH_EST_STEPS),
        f"mesh train rank {rank}: estimator {res['estimator']}")
    return res


def mesh_transe_rank(work: str, mesh, dev) -> dict:
    """TransE (shard_embeddings) over this rank's shard of the transe
    graph: its entity block from the parent's dense table (row r on shard
    r % S), one step of 1024 triples a rank (the parent's, each owner's
    negative uniforms its own) whose synced gradients and negatives are
    written for the parent, with its launches (none: the entity rows
    move by the owner exchange, not by ``gather_rows``); a few steps
    timed."""
    view = sharded.load_shard(os.path.join(work, "transe"),
                              mesh.graph_index, dev, mesh)
    model = kg.TransE(n_entities=TRANSE_NODES,
                      n_relations=bench.TRANSE_RELATIONS,
                      ent_dim=bench.TRANSE_DIM, rel_dim=bench.TRANSE_DIM,
                      num_negs=bench.TRANSE_NEGS, shard_embeddings=True,
                      device=dev, generator=torch.Generator().manual_seed(0))
    sharded_train.init_sharded_params(model, mesh)
    dense = torch.load(os.path.join(work, "transe_model.pt"),
                       map_location=dev)
    S, gi = mesh.graph, mesh.graph_index
    block = model.entity_encoder.embedding
    with torch.no_grad():
        rows = dense.pop("entity_encoder.weight")[gi::S]
        block.zero_()
        block[:rows.shape[0]] = rows
        for name, p in model.named_parameters():
            if name in dense:
                p.copy_(dense[name])
    with np.load(os.path.join(work, "transe_inputs.npz")) as z:
        triples = torch.from_numpy(z["triples"]).to(dev)
        u = [torch.from_numpy(z[f"u{i}"][mesh.rank]).to(dev)
             for i in range(4)]
    rec = GradRecorder(model.named_parameters())
    step = sharded_train.make_sharded_train_step(
        model, rec, mesh, MESH_TRANSE_BATCH,
        ids_fn=sharded_train.edge_ids_fn())
    kr = KernelRecorder(eager=True)
    reset_counts()
    with kr:
        loss = float(step(view, ids=triples, uniforms=u))
    launches = read_counts()
    check(launches == kernel_counts(fan_draw=0, gather_rows=0),
          f"mesh transe rank {mesh.rank}: launches {launches}, want none")
    kr.check_plain(f"mesh transe rank {mesh.rank}")
    with torch.no_grad():
        negs = sampling.select_nodes(view, -1, *u)
    torch.save(dict(loss=loss, negs=negs.cpu(),
                    grads={k: v.cpu() for k, v in rec.grads.items()}),
               os.path.join(work, f"transe_{mesh.rank}.pt"))
    out = dict(loss=loss, launches=launches,
               bytes_per_step=account_step(lambda: step(view, seed=5)))
    ms = [cuda_ms(lambda i=i: step(view, seed=10 + i)) for i in range(5)]
    out.update(step_ms=ms, step_ms_median=statistics.median(ms))
    return out


def mesh_gcn_rank(work: str, mesh, dev) -> dict:
    """gcn over psum blocks: this rank's shard of the 10,000-node graph,
    one step of MESH_GCN_ROOTS roots a rank (the parent's) whose loss and
    synced gradients are written for the parent, with its 2
    ``gather_rows`` launches each held against its plain version; a few
    steps timed."""
    view = sharded.load_shard(os.path.join(work, "gcn"), mesh.graph_index,
                              dev, mesh)
    model = whole_model("gcn", dev, layout="edge_list")
    model.load_state_dict(torch.load(os.path.join(work, "gcn_model.pt"),
                                     map_location=dev))
    rec = GradRecorder(model.named_parameters())
    step = sharded_train.make_sharded_train_step(model, rec, mesh,
                                                 MESH_GCN_ROOTS)
    with np.load(os.path.join(work, "gcn_inputs.npz")) as z:
        roots = torch.from_numpy(z["roots"]).to(dev)
    kr = KernelRecorder(eager=True)
    reset_counts()
    with kr:
        loss = float(step(view, ids=roots))
    launches = read_counts()
    check(launches == kernel_counts(fan_draw=0, gather_rows=2,
                                    sigmoid_xent=HEAD_STEP),
          f"mesh gcn rank {mesh.rank}: launches {launches}, want 0 + 2 "
          f"and the loss's 2")
    checked = kr.check_plain(f"mesh gcn rank {mesh.rank}")
    check(checked == launches,
          f"mesh gcn rank {mesh.rank}: {checked} held against their plain "
          f"versions of {launches}")
    torch.save(dict(loss=loss, grads={k: v.cpu()
                                      for k, v in rec.grads.items()}),
               os.path.join(work, f"gcn_{mesh.rank}.pt"))
    out = dict(loss=loss, launches=launches,
               bytes_per_step=account_step(lambda: step(view, seed=5)))
    ms = [cuda_ms(lambda i=i: step(view, seed=10 + i)) for i in range(3)]
    out.update(step_ms=ms, step_ms_median=statistics.median(ms))
    return out


def close_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (0 where both are 0)."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err / scale if scale else err


def transe_reference(work: str, dev) -> tuple:
    """The transe part's host side: the graph of phase 12c, its 4 shards,
    the dense model's weights, 4 x 1024 triples and each rank's negative
    uniforms; returns (graph, model)."""
    g = random_graph(TRANSE_NODES, AVG_DEGREE, seed=0,
                     num_edge_types=bench.TRANSE_RELATIONS, packs=(),
                     device=dev)
    sharded.write_shards(sharded.build_sharded(g, MESH_SHARDS),
                         os.path.join(work, "transe"))
    model = kg_model(kg.TransE, dev)
    torch.save(model.state_dict(), os.path.join(work, "transe_model.pt"))
    gen = torch.Generator(device=dev).manual_seed(15)
    triples = edge_triples(g.tensors, MESH_SHARDS * MESH_TRANSE_BATCH, gen)
    rng = np.random.default_rng(15)
    n = MESH_TRANSE_BATCH * bench.TRANSE_NEGS
    np.savez(os.path.join(work, "transe_inputs.npz"),
             triples=triples.cpu().numpy(),
             **{f"u{i}": rng.random((MESH_SHARDS, n), dtype=np.float32)
                for i in range(4)})
    return g, model, triples


def transe_check(work: str, g, model, triples) -> dict:
    """The one-card step of the dense TransE over the 4 x 1024 triples
    with the negatives the ranks drew: its loss equals the mean of the
    ranks' losses, the relation tables' gradients the ranks' (replicated:
    the mean of the ranks' gradients) and each rank's entity block
    gradient S times the one-card table's rows of that block (the
    reference's scale: the graph group's sum), each within 1e-4 of the
    largest."""
    ranks_out = [torch.load(os.path.join(work, f"transe_{r}.pt"))
                 for r in range(MESH_SHARDS)]
    negs = torch.cat([o["negs"] for o in ranks_out]).to(g.tensors.device)
    real = sampling.select_nodes
    sampling.select_nodes = lambda *a, **k: negs
    try:
        model.train()
        model.zero_grad(set_to_none=True)
        out = model(g.tensors, triples, uniforms=(None,) * 3)
        out["loss"].backward()
    finally:
        sampling.select_nodes = real
    loss = out["loss"].item()
    mean = float(np.mean([o["loss"] for o in ranks_out]))
    res = dict(loss=loss, loss_abs_err=abs(loss - mean), rel_err={})
    check(abs(loss - mean) <= 1e-4 * max(1.0, abs(loss)),
          f"mesh transe: loss {mean} != one card {loss}")
    full = model.entity_encoder.weight.grad.cpu()
    for name, p in model.named_parameters():
        if name == "entity_encoder.weight":
            continue
        errs = [close_rel(o["grads"][name], p.grad.cpu()) for o in ranks_out]
        res["rel_err"][name] = max(errs)
    for r, o in enumerate(ranks_out):
        want = MESH_SHARDS * full[r::MESH_SHARDS]
        got = o["grads"]["entity_encoder.embedding"][:want.shape[0]]
        res["rel_err"].setdefault("entity_block", 0.0)
        res["rel_err"]["entity_block"] = max(res["rel_err"]["entity_block"],
                                             close_rel(got, want))
    for name, err in res["rel_err"].items():
        check(err <= 1e-4, f"mesh transe: {name} gradient off by {err} of "
                           f"its largest")
    return res


def gcn_reference(work: str, dev) -> tuple:
    g = random_graph(MESH_GCN_NODES, AVG_DEGREE, feat_dim=FEAT_DIM,
                     n_classes=N_CLASSES, seed=0, packs=(), device=dev)
    sharded.write_shards(sharded.build_sharded(g, MESH_SHARDS),
                         os.path.join(work, "gcn"))
    model = whole_model("gcn", dev, layout="edge_list")
    torch.save(model.state_dict(), os.path.join(work, "gcn_model.pt"))
    roots = np.random.default_rng(16).integers(
        0, MESH_GCN_NODES, MESH_SHARDS * MESH_GCN_ROOTS).astype(np.int32)
    np.savez(os.path.join(work, "gcn_inputs.npz"), roots=roots)
    return g, model, torch.from_numpy(roots).to(dev)


def gcn_check(work: str, g, model, roots) -> dict:
    """The one-card gcn step over every rank's roots: its loss equals
    the mean of the ranks' and every gradient the ranks' synced one
    within 1e-4 of its largest."""
    ranks_out = [torch.load(os.path.join(work, f"gcn_{r}.pt"))
                 for r in range(MESH_SHARDS)]
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(g.tensors, roots)
    out["loss"].backward()
    loss = out["loss"].item()
    mean = float(np.mean([o["loss"] for o in ranks_out]))
    res = dict(loss=loss, loss_abs_err=abs(loss - mean), rel_err={})
    check(abs(loss - mean) <= 1e-4 * max(1.0, abs(loss)),
          f"mesh gcn: loss {mean} != one card {loss}")
    for name, p in model.named_parameters():
        res["rel_err"][name] = max(close_rel(o["grads"][name], p.grad.cpu())
                                   for o in ranks_out)
        check(res["rel_err"][name] <= 1e-4,
              f"mesh gcn: {name} gradient off by {res['rel_err'][name]}")
    return res


def phase_mesh_train(graph, dev, smi: str, sgs: dict) -> dict:
    """Phase 15: training over the mesh (see the module docstring)."""
    t_phase = time.perf_counter()
    work = MESH_TRAIN_DIR
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {}
    g = graph.tensors
    model = bench.make_model("sage", dev,
                             generator=torch.Generator().manual_seed(15))
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save(state0, os.path.join(work, "model.pt"))
    flow = model.embedder.flow
    rng = np.random.default_rng(15)
    gen = torch.Generator(device=dev).manual_seed(15)
    W = MESH_SHARDS
    roots = [torch.from_numpy(rng.integers(0, N_NODES, W * BATCH).astype(
        np.int32)).to(dev) for _ in range(MESH_TRAIN_STEPS)]
    U = [hop_uniforms(flow, g, r, gen) for r in roots]
    owners = hop_owners(flow, BATCH, W)
    # the NCCL rank's one-card steps over rank 0's roots on the one
    # shard's reservoir rows, then the 4 ranks' on the 4 shards'
    t0 = time.perf_counter()
    adopt_shard_reservoirs(g, sgs[1])
    u0 = [owner_uniforms(u, owners, [0]) for u in U]
    losses1, want1, _ = onecard_sage_steps(state0, graph, dev,
                                           [r[:BATCH] for r in roots], u0)
    adopt_shard_reservoirs(g, sgs[MESH_SHARDS])
    losses4, want4, step_ms = onecard_sage_steps(state0, graph, dev, roots,
                                                 U)
    out["onecard_step_ms"] = step_ms
    out["onecard_s"] = time.perf_counter() - t0
    for tag, ids, u_of, losses, want in (
            ("gloo", roots, lambda t: owner_uniforms(U[t], owners,
                                                     range(W)), losses4,
             want4),
            ("nccl", [r[:BATCH] for r in roots], lambda t: u0[t], losses1,
             want1)):
        arrays = dict(losses=np.array(losses), step_ms=np.array(step_ms))
        for t in range(MESH_TRAIN_STEPS):
            arrays[f"t{t}_ids"] = ids[t].cpu().numpy()
            for h, hop in enumerate(u_of(t)):
                for i, x in enumerate(hop):
                    arrays[f"t{t}_h{h}_u{i}"] = x.cpu().numpy()
        np.savez(os.path.join(work, f"inputs_{tag}.npz"), **arrays)
        torch.save(want, os.path.join(work, f"want_{tag}.pt"))
    out["onecard_losses"] = losses4
    t0 = time.perf_counter()
    tg, tmodel, triples = transe_reference(work, dev)
    gg, gmodel, groots = gcn_reference(work, dev)
    out["host_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["gloo"] = launcher.launch(
        mesh_train_rank, W, "gloo", MESH_TIMEOUT_S,
        args=(work, "gloo", 1, W, "gloo",
              os.path.join(MESH_DIR, f"shards{W}"), time.time()))
    out["gloo_s"] = time.perf_counter() - t0
    states = [torch.load(os.path.join(work, f"state_gloo_{r}.pt"))
              for r in range(W)]
    for r in range(1, W):
        for k, v in states[0].items():
            check(torch.equal(states[r][k], v),
                  f"mesh train: replicated {k} differs on rank {r}")
    out["replicated_bit_equal"] = True
    out["transe"] = transe_check(work, tg, tmodel, triples)
    out["gcn"] = gcn_check(work, gg, gmodel, groots)
    del tg, tmodel, gg, gmodel
    t0 = time.perf_counter()
    mesh = mesh_lib.make_mesh(
        1, 1, backend="nccl", device=torch.device("cuda", 0),
        init_method="file://" + os.path.join(work, "rendezvous_nccl"),
        rank=0, timeout_s=MESH_TIMEOUT_S)
    try:
        out["nccl"] = [mesh_train_serve(
            work, "nccl", mesh, sharded.take_shard(sgs[1], 0, mesh.device,
                                                   mesh), t0)]
    finally:
        mesh_lib.close()
    out["nccl_s"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    shutil.rmtree(work, ignore_errors=True)
    for tag in ("gloo", "nccl"):
        for res in out[tag]:
            log(f"mesh train {tag} rank {res['rank']}: "
                f"{res['step_ms_median']:.4f} ms per step (CUDA-event "
                f"median of {MESH_TRAIN_TIMED}, {BATCH} roots a rank); "
                f"{smi}")
        acct = out[tag][0]["bytes_per_step"]
        log(f"mesh train {tag} rank 0 bytes per step: "
            f"{json.dumps({k: v for k, v in acct.items() if k != 'table'})}"
            f"; link {out[tag][0]['link_bytes_per_s']:.4g} B/s (one psum "
            f"of 64 MiB); {smi}")
        log(f"mesh train {tag} rank 0 comms.account() table:\n"
            f"{acct['table']}")
        if "profile" in out[tag][0]:
            log(f"mesh train {tag} rank 0 profile: "
                f"{json.dumps(out[tag][0]['profile'])}; {smi}")
    for part in ("transe", "gcn"):
        r0 = out["gloo"][0][part]
        acct = {k: v for k, v in r0["bytes_per_step"].items()
                if k != "table"}
        log(f"mesh {part} (4 gloo ranks): {r0['step_ms_median']:.4f} ms "
            f"per step on rank 0; bytes per step {json.dumps(acct)}; vs "
            f"one card "
            f"{json.dumps(out[part])}; {smi}")
    log(f"mesh train single card: {out['onecard_step_ms']:.4f} ms per "
        f"eager train step of {BATCH} roots (CUDA-event median of "
        f"{MESH_TRAIN_TIMED}); {smi}")
    log(f"mesh train phase: {out['seconds']:.1f} s (one-card steps "
        f"{out['onecard_s']:.1f} s, transe and gcn on the host "
        f"{out['host_s']:.1f} s, gloo ranks {out['gloo_s']:.1f} s, the nccl "
        f"rank {out['nccl_s']:.1f} s); {smi}")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--parent", metavar="DIR",
        help="a copy of the parent commit's tree: its fan_draw, "
             "gather_rows and GAT kernels are built too and timed in "
             "turns with this checkout's, and its ptxas figures logged")
    parser.add_argument(
        "--only", choices=("rgcn", "xent"),
        help="run the device checks, the builds and this phase alone "
             "(rgcn: phase 12r, the rgcn-train cell's typed mean kernels; "
             "xent: phase 12s, the supervised head's loss kernels)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {name} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # 2. build: the nvcc builds, their -Xptxas -v twins and g++, all
    # started together
    t0 = time.perf_counter()
    cuda_sources = ("fan_draw", "gather_rows", "ell_agg", "ell_attn",
                    "rel_agg", "sigmoid_xent")
    with concurrent.futures.ThreadPoolExecutor(15) as ex:
        builds = [ex.submit(f) for f in (fd.build, gr.build, ell_ops.build,
                                         attn_ops.build, rel_agg.build,
                                         xent_ops.build, native.get_lib)]
        reports = {n: ex.submit(ptxas_report, n) for n in cuda_sources}
        # the parent's sources, but for kernels this checkout added
        parent_pkg = os.path.join(args.parent or "", "euler_tpu_torch")
        parent_reports = {n: ex.submit(ptxas_report, n, parent_pkg)
                          for n in (cuda_sources if args.parent else ())
                          if os.path.exists(os.path.join(
                              parent_pkg, "csrc", f"{n}.cu"))}
        for b in builds:
            b.result()
        ptxas = {n: r.result() for n, r in reports.items()}
        parent_ptxas = {n: r.result() for n, r in parent_reports.items()}
    build_s = time.perf_counter() - t0
    check(native.available(), f"native host core built from {native.SRC}")
    check(os.path.commonpath([native.SRC, PACKAGE_DIR]) == PACKAGE_DIR,
          f"native host core source {native.SRC} lies in {PACKAGE_DIR}")
    log(f"build: {build_s:.1f} s (fan_draw.cu, gather_rows.cu, "
        f"ell_agg.cu, ell_attn.cu, rel_agg.cu and sigmoid_xent.cu by nvcc, "
        f"sm_90a); native host core loaded: {native.available()}, from "
        f"{os.path.relpath(native.SRC)} into "
        f"{os.path.relpath(native.get_lib()._name)}")
    log(f"ptxas: {json.dumps(ptxas)}")
    if args.parent:
        log(f"ptxas parent: {json.dumps(parent_ptxas)}")
    parent = load_parent(args.parent) if args.parent else None
    if args.only:
        res = {"rgcn": phase_rgcn, "xent": phase_xent}[args.only](dev)
        log(json.dumps({"ok": True, "only": args.only, args.only: res,
                        "seconds": time.perf_counter() - t_start}))
        return 0

    # 3. fan_draw vs plain; 4. gather_rows vs plain
    shapes, crossover, launch_floor_ms = phase_kernel(dev, parent)
    unions = phase_union(dev)
    gathers = phase_gather(dev, parent)
    log(f"kernels: phases 3-4, {time.perf_counter() - t_start:.1f} s in")

    # 5. graph
    t0 = time.perf_counter()
    graph = random_graph(N_NODES, AVG_DEGREE, feat_dim=FEAT_DIM,
                         n_classes=N_CLASSES, seed=0, packs=("fan",))
    graph_s = time.perf_counter() - t0
    check(graph.tensors.fan_pack.is_cuda, "graph on the card")
    log(f"graph: {N_NODES} nodes, {graph.meta.n_edges} edges, "
        f"{int(graph.tensors.fan_over_rows.numel())} reservoir rows, "
        f"built in {graph_s:.1f} s")

    # 6. model
    model = bench.make_model("sage", dev,
                             generator=torch.Generator().manual_seed(0))
    model.eval()

    with tempfile.TemporaryDirectory() as out_dir:
        # 7. infer (the serving path)
        emb, infer = phase_infer(model, graph, out_dir, dev)
        log(f"infer: {json.dumps(infer)}")
        infer_prof = phase_profile(model, graph, dev)
        infer.update(profile_host_ms=infer_prof["host_ms"],
                     profile_device_busy_ms=infer_prof["device_busy_ms"],
                     profile_complete=infer_prof["kernel_events_complete"])
        # 8. card vs CPU
        parity = phase_parity(model, graph, dev)
        log(f"parity: {json.dumps(parity)}")
        # 9. serve
        served = phase_serve(out_dir)
        log(f"serve: {json.dumps(served)}")

    # the device memory still allocated after each phase from here on
    allocated = {}

    def allocated_after(phase: str) -> None:
        allocated[phase] = torch.cuda.memory_allocated() / 1e9
        log(f"memory: {allocated[phase]:.3f} GB allocated after {phase}, "
            f"{time.perf_counter() - t_start:.1f} s in")
    allocated_after("serving")
    # 10. train (the training path)
    train = phase_train(model, graph, dev)
    log(f"train: {json.dumps(train)}")
    allocated_after("train")
    # 11. one step's loss and gradients, card vs CPU
    grads = phase_grads(model, graph, dev)
    log(f"grads: {json.dumps(grads)}")
    # 12. gin, gat and rgcn
    families = phase_families(graph, dev)
    allocated_after("families")
    # 12c. transe; 12d. unsupervised GraphSAGE on the graph of phase 5
    transe = phase_transe(dev)
    allocated_after("transe")
    unsup = phase_unsup(graph, dev)
    allocated_after("unsup")
    # 12e. every family's train loop as a captured step replayed
    loop = phase_loop(graph, dev)
    allocated_after("loop")
    # 12f. the other eight convs; 12h. the id and sparse-id encoder
    conv_runs = phase_convs(graph, dev)
    allocated_after("convs")
    encoder = phase_encoder(graph, dev)
    allocated_after("encoder")
    # 12i. sage's deepest fetch deduplicated, then the walk family on a
    # graph of its own
    dedup = phase_dedup(graph, dev)
    allocated_after("dedup")
    # 12l. the query path and the IVF index on the graph of phase 5
    queried = phase_query(graph, dev)
    allocated_after("query")
    # 14. sharded sage serving over 4 gloo ranks and one NCCL rank; 15.
    # training over the mesh on the same shards
    meshed, mesh_shards = phase_mesh(graph, model, dev, smi)
    allocated_after("mesh")
    mesh_trained = phase_mesh_train(graph, dev, smi, mesh_shards)
    del mesh_shards
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    allocated_after("mesh train")
    del graph
    allocated_after("del graph")
    walks = phase_walk(dev)
    allocated_after("walk")
    # 12j. this slice's families: the layerwise flows and the rest of the
    # models
    rest = phase_rest(dev)
    allocated_after("rest")
    # 12b. whole-graph gcn; 12g. the examples' whole-graph convs
    gcn = phase_gcn(dev)
    allocated_after("gcn")
    whole = phase_whole(dev)
    allocated_after("whole")
    # 12n. the gat-train cell's attention kernels at its shapes
    gat = phase_gat(dev, parent)
    allocated_after("gat")
    # 12r. the rgcn-train cell's typed mean kernels at its shapes
    phase_rgcn(dev)
    allocated_after("rgcn")
    # 12s. the supervised head's loss kernels at the rgcn-train cell's shape
    phase_xent(dev)
    allocated_after("xent")
    # 12k. the data plane: convert, load, the fan-less and payload paths,
    # the example scripts
    data = phase_data(dev)
    allocated_after("data")
    # 12m. this slice's example scripts
    examples = phase_examples(dev)
    allocated_after("examples")
    # 13. the port's bench, every mode
    benched = phase_bench(dev)
    allocated_after("bench")
    # 16. the tools: bench.py's size and dedup knobs at 1M nodes, the
    # bench suite, the scaling bench, the ingest drill, the parity harness
    tools = phase_tools(dev, smi, mesh_trained["gloo"][0]["link_bytes_per_s"])
    allocated_after("tools")
    # 17. the driver's entry points: entry()'s forward, dryrun_multichip on
    # one NCCL rank and on 4 gloo ranks, ppermute on those ranks
    graft = phase_graft(dev, smi)
    allocated_after("graft")

    # each path's launches, its counts set to 0 just before it
    path_launches = {"infer": infer["launches"], "train": train["launches"],
                     "bench": benched["sage"]["launches"]}
    for family, res in list(families.items()) + [("gcn", gcn)]:
        path_launches.update({f"{family}_infer": res["infer"]["launches"],
                              f"{family}_train": res["train"]["launches"],
                              f"bench_{family}":
                                  benched[family]["launches"]})
    path_launches.update(transe_train=transe["launches"],
                         bench_transe=benched["transe"]["launches"],
                         unsup_infer=unsup["infer"]["launches"],
                         unsup_train=unsup["train"]["launches"])
    path_launches.update({f"loop_{family}": loop[family]["launches"]
                          for family in LOOP_FAMILIES})
    path_launches.update({f"loop_bench_{mode}": loop["bench"][mode]["launches"]
                          for mode in LOOP_BENCH_MODES})
    for conv in bench.CONV_MODES:
        res = conv_runs[conv]
        path_launches.update({f"{conv}_infer": res["infer"]["launches"],
                              f"loop_{conv}": res["loop"]["launches"],
                              f"bench_{conv}": benched[conv]["launches"]})
    path_launches.update({f"whole_{conv}_train": whole[conv]["launches"]
                          for conv in WHOLE_CONVS})
    path_launches.update({f"loop_encoder_{c}": encoder[c]["loop"]["launches"]
                          for c in ("sum", "mean")})
    path_launches["loop_sage_dedup"] = dedup["loop"]["launches"]
    path_launches["loop_gat_heads"] = gat["loop"]["launches"]
    for model in WALK_MODELS:
        path_launches.update({
            f"{model}_evaluate_infer": walks[model]["serve"]["launches"],
            f"loop_{model}": walks[model]["loop"]["launches"]})

    path_launches.update({f"loop_{family}": rest[family]["loop"]["launches"]
                          for family in REST_FAMILIES})
    path_launches.update({f"data_{k}": data[k]["launches"] for k in (
        "fan_step", "bf16_step", "fallback_step", "rgcn_step", "fan_loop",
        "fallback_loop")})
    path_launches.update({f"example_{name}": data["examples"][name][
        "launches"] for name in ("graphsage", "gcn", "rgcn")})
    path_launches.update({f"query_{name}": res["launches"]
                          for name, res in queried["queries"].items()})
    path_launches["ivf_search"] = queried["ivf"]["launches"]
    path_launches.update({f"example_{script}": examples[script]["launches"]
                          for _, script in EXAMPLES_12M})
    path_launches.update({f"mesh_{tag}_rank{res['rank']}": res["launches"]
                          for tag in ("gloo", "nccl")
                          for res in meshed[tag]})
    # phase 15: a checked train step a rank, and the estimator's steps
    path_launches.update({
        f"mesh_train_{tag}_rank{res['rank']}": res["launches"]
        for tag in ("gloo", "nccl") for res in mesh_trained[tag]})
    path_launches.update({
        f"mesh_train_estimator_{tag}_rank{res['rank']}":
            res["estimator"]["launches"]
        for tag in ("gloo", "nccl") for res in mesh_trained[tag]})
    # phase 16: the 1M-node bench, the scaling bench's timed steps on each
    # rank, the drill's probed payload sage step on each rank
    path_launches.update({f"bench_1m_{k}": tools["bench"][k]["launches"]
                          for k in ("plain", "dedup")})
    path_launches.update({
        f"scaling_{shape['mesh']}_rank{r}": n
        for shape in tools["scaling"]["shapes"]
        for r, n in enumerate(shape["launches"])})
    path_launches.update({
        f"drill_sage_step_rank{r['rank']}": r["probe"]["launches"]
        for r in tools["drill"]["record"]["ranks"]})
    # phase 17: entry()'s forward, each dryrun rank's first sharded step
    path_launches["entry_forward"] = graft["entry"]["launches"]
    path_launches.update({f"dryrun_{tag}_rank{r}": n
                          for tag in ("nccl", "gloo")
                          for r, n in enumerate(graft[tag]["launches"])})

    def mesh_shapes(name, run=None):
        """One sharded batch's (or train step's) launches of ``name`` on
        rank 0 of each mesh, at their shapes."""
        run = meshed if run is None else run
        return [dict(backend=tag, **{k: v for k, v in row.items()
                                      if k != "name"})
                for tag in ("gloo", "nccl")
                for row in run[tag][0]["kernels"] if row["name"] == name]

    def tools_shapes(name):
        return [{k: v for k, v in row.items() if k != "name"}
                for row in tools["bench"]["plain"]["kernels"]
                if row["name"] == name]

    def entry_shapes(name):
        return [{k: v for k, v in row.items() if k != "name"}
                for row in graft["entry"]["kernels"] if row["name"] == name]

    def by_path(name):
        return {path: n[name] for path, n in path_launches.items()}

    hop = [s for s in shapes if "ms" in s]
    timed = [g for g in gathers if g.get("timed") == "sampled"]
    gcn_gathers = [g for g in gathers if g.get("timed") == "gcn"]
    # the f32 gather as the train path runs it, the bf16 one as the bench
    f32_gather, bf16_gather = timed
    kernels = [{
        "name": "fan_draw", "route": "cuda",
        "source": "euler_tpu_torch/csrc/fan_draw.cu",
        "replaces": "euler_tpu/ops/pallas_fan.py:96",
        "launches": train["launches"]["fan_draw"],
        "launches_by_path": by_path("fan_draw"),
        "bit_exact": True,
        "max_abs_err": max([s["max_abs_err"] for s in shapes]
                           + [u[k]["max_abs_err"] for u in unions
                              for k in ("union", "typed")]),
        # per batch or step: one launch at each hop shape
        "ms": sum(s["ms"] for s in hop),
        "plain_ms": sum(s["plain_ms"] for s in hop),
        "bound_ms": sum(s["bound_ms"] for s in hop),
        "bound_by": "bytes",
        "library_ms": None,
        "launch_floor_ms": launch_floor_ms,
        "ptxas": ptxas["fan_draw"],
        "shapes": [{k: s[k] for k in ("B", "C", "ms", "plain_ms", "bound_ms",
                                      "bytes", "turns_ms") if k in s}
                   for s in hop],
        # the union epilogue with types (rgcn's hops), and the untyped
        # draw in turns with it
        "union_shapes": [{k: u[k] for k in ("B", "C", "ms", "plain_ms",
                                            "bound_ms", "bytes",
                                            "turns_ms")}
                         for u in unions],
        "paths_ms": crossover,
        # the unsupervised step's shapes, on its own frontiers
        "unsup_shapes": unsup["kernels"]["fan_draw"],
        # each owner's draw over the spread rows of 4 gloo ranks' hops
        # (local rows, -1 where another shard owns the id), and the NCCL
        # rank's over the whole graph as one shard
        "mesh_shapes": mesh_shapes("fan_draw"),
        # the same in a train step at 1024 roots a rank (phase 15)
        "mesh_train_shapes": mesh_shapes("fan_draw", mesh_trained),
        # the bench's captured step over the [1M, 128] fan pack (phase 16)
        "bench_1m_shapes": tools_shapes("fan_draw"),
        # entry()'s forward: (B, C) = (32, 5), then (192, 5) (phase 17)
        "entry_shapes": entry_shapes("fan_draw"),
    }, {
        "name": "gather_rows", "route": "cuda",
        "source": "euler_tpu_torch/csrc/gather_rows.cu",
        "replaces": "tools/micro/micro_pallas_gather.py:32",
        "launches": train["launches"]["gather_rows"],
        "launches_by_path": by_path("gather_rows"),
        "bit_exact": True,
        "max_abs_err": max(g["max_abs_err"] for g in gathers),
        # the deepest feature gather (M=292,864, D=128) in f32, and beside
        # it in bf16; library_ms is torch.index_select on clamped ids,
        # which skips the fills
        **{f"{k}{sfx}": g[k]
           for g, sfx in ((f32_gather, ""), (bf16_gather, "_bf16"))
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "bytes",
        "ptxas": ptxas["gather_rows"],
        "shapes": [{k: g[k] for k in ("N", "D", "M", "dtype", "ms",
                                      "plain_ms", "library_ms", "copy_ms",
                                      "sorted_ms", "distinct_ms",
                                      "distinct_bound_ms", "bound_ms",
                                      "bytes", "distinct_rows", "turns_ms")
                    if k in g}
                   for g in timed],
        # the whole-graph gcn gathers: every feature row once, ids arange(N)
        "gcn_shapes": [{k: g[k] for k in ("N", "D", "M", "dtype", "ms",
                                          "plain_ms", "library_ms",
                                          "copy_ms", "bound_ms", "bytes")}
                       for g in gcn_gathers],
        # the unsupervised step's negatives tower, on its own ids
        "unsup_shapes": unsup["kernels"]["gather_rows"],
        # each owner's feature and label answers (request-routed over 4
        # gloo ranks; spread on the NCCL rank's one shard)
        "mesh_shapes": mesh_shapes("gather_rows"),
        "mesh_train_shapes": mesh_shapes("gather_rows", mesh_trained),
        # the bench's captured step from the [1M, 128] bf16 table, and the
        # deepest hop's gather from [1M, 128] f32 and bf16 tables
        "bench_1m_shapes": tools_shapes("gather_rows"),
        "gather_1m": tools["bench"]["gather_1m"],
        # entry()'s forward: 1,152 feature rows from [256, 16], 32 labels
        "entry_shapes": entry_shapes("gather_rows"),
    }, {
        "name": "ell_agg", "route": "cuda",
        "source": "euler_tpu_torch/csrc/ell_agg.cu",
        # no TPU kernel: the reference's _ell_agg is jnp left to XLA
        "replaces": None,
        # phase 12b's 8 f32 gcn steps: 3 a step
        "launches": gcn["train"]["launches"]["ell_agg"],
        "launches_by_path": by_path("ell_agg"),
        "bit_exact": False,
        "max_plain_gap": max(r["plain_gap"] for r in
                             gcn["ell_agg"] + gcn["ell_agg_cell"]),
        "bound_by": "bytes",
        "ptxas": ptxas["ell_agg"],
        # both modes at D = 128 and 256, bf16 and f32 (time_ell_agg), on
        # bench.py's gcn graph (N 100,000) and the gcn-train cell's
        # (N 169,343)
        "shapes": gcn["ell_agg"] + gcn["ell_agg_cell"],
    }] + [{
        "name": name, "route": "cuda",
        "source": "euler_tpu_torch/csrc/ell_attn.cu",
        # no TPU kernel: the reference's GAT is single-head, its ELL
        # aggregate jnp left to XLA
        "replaces": None,
        "launches_by_path": by_path(name),
        "bit_exact": False,
        "max_plain_gap": max(r["plain_gap"] for r in gat["rows"]
                             if r["kernel"] == name),
        "bound_by": "bytes",
        "ptxas": ptxas["ell_attn"],
        # the gat-train cell's block, 3 heads of 250, bf16 (phase_gat)
        "shapes": [r for r in gat["rows"] if r["kernel"] == name],
    } for name in ("ell_sddmm", "ell_gat")]
    log(json.dumps({"smoke": dict(
        build_s=build_s, graph_s=graph_s,
        total_s=time.perf_counter() - t_start,
        native_core=native.available(), infer=infer, parity=parity,
        train=train, grads=grads, families=families, gcn=gcn, gat=gat,
        convs=conv_runs, whole=whole, encoder=encoder, transe=transe,
        dedup=dedup, walk=walks, rest=rest, data=data, query=queried,
        examples=examples, mesh=meshed, mesh_train=mesh_trained,
        tools=tools, graft=graft,
        unsup={k: v for k, v in unsup.items() if k != "kernels"}, loop=loop,
        bench=benched, allocated_gb_after=allocated)}))
    log(smi)                # nvidia-smi's name and power limit, as given
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
