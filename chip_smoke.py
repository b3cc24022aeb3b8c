#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero (no
phase falls back to the host or to a plain version):

1. device: require CUDA; print the card's name and power limit.
2. build: compile every CUDA source of the port, all at once (timed),
   with ptxas's register and spill report of each instantiation; a
   missing instantiation of an attention kernel, or a spill in one at
   any head dim (32, 64, 128), fails.
3. kernels: each kernel against its plain PyTorch version on the same
   CUDA inputs (fp32 at head dims 32, 64 and 128; fp32, bf16 and fp16 on
   the tensor-core K1/K2 and bf16/fp16 on K3 at ragged and cross shapes,
   WGMMA_CASES; held to ``ops.flash_attention.kernel_tolerance``, the
   largest share of it logged per dtype), and at the shape the main
   path gives it, where it is timed beside its plain version, the
   library call that computes the same function, and its bound: the
   forward (K1) at the serving shape, the backward (K2 dK/dV, K3 dQ) at
   the training shape, with the backward's peak memory held below one
   fp32 score matrix; the fp32 route of each at the same shape (K1-K3
   split TF32 on the tensor cores, each after its pre-pass, timed apart
   by kernel), held against its plain version there, beside its FFMA and
   3xTF32 bounds and SDPA's fp32 call (the rows' ``fp32``). At every
   bf16/fp16 backward case the atol floor from the inputs
   (``backward_atol_floor``) must lie below the atol the comparison
   uses, its largest share logged.
4. attention served: ``InferenceServer`` over
   ``nd.contrib.flash_attention`` (16 heads x 64, T 2048, causal, bf16).
5. ResNet-50 v1 served at full width (224x224, 1000 classes, buckets
   1/8/32) in fp32 and bf16; fp32 outputs against the same net on the
   host, and img/s at batch 32.
6. attention trained: ``TrainStep`` (bf16, fp32 masters) over
   ``examples.attention_layer.SelfAttention``, built from the public API
   (Dense 3072, 16 heads x 64 through ``F.contrib.flash_attention``,
   Dense 1024) at B 8, T 2048 with ``L2Loss`` to a fixed random target:
   K1, K2 and K3 launch once per step and the loss falls; one fp32 step
   at T 256 on the card against the same step on the host, where K1, K2
   and K3 (their fp32 route) launch once each (the kernels line's
   ``attention_trained_fp32`` path).
7. ResNet-50 v1 trained at full width: img/s at batch 32 through
   ``examples.train_imagenet.benchmark_rate`` in fp32 (TF32 off) and
   bf16, no flash-attention kernel launched; then, for the seeds of
   ``PARITY_SEEDS``, one
   step at batch 8 from the same weights in fp32 and float64 on the card
   and on the host: the float64 steps agree to float64 rounding, and the
   card's fp32 update is as close to the float64 one, tensor by tensor,
   as the host's fp32 update is (PARITY_LIMITS).

8. rtc direct (K4): ``rtc.CudaModule`` compiles ``csrc/rtc/*.cu`` with
   NVRTC for sm_90a (compile time and cache counts logged); scale_add
   launched through the CudaKernel API on the JAX fixture's (1, 8) and
   at 4096x4096, and relu as the rtc kernel of a partitioned dense-relu
   MLP (b32, 1024 -> 4096 -> 1000), each exact against its plain version;
   then (not counted) scale_add on views one element past a 16-byte
   boundary at an odd n, through CudaKernel.launch and the wrapper.
9. rtc kernels: scale_add and relu timed beside their plain versions,
   torch calls (device time and back-to-back) and bounds, relu also at
   4096x4096; fused BatchNorm(inference)+ReLU at each
   distinct ResNet-50 v1 b32 shape against its plain version (rtol 1e-5
   + 1e-6 max|want|), timed beside it, ``F.batch_norm`` + ``F.relu``
   and its bytes bound; its two-output variant held at one shape; the
   host cost of one ``CudaKernel.launch``. The rtc rows are timed with
   the card kept ahead of the host (time_queued: device time), and the
   kernels also as back-to-back calls (``ms_host_window``).
10. ResNet-50 v1 served from a checkpoint: the gluon net (BatchNorm
   statistics randomized) is exported and served through
   ``InferenceServer.from_checkpoint`` (fp32, TF32 off, buckets
   1/8/32), plain and with ``MXNET_SUBGRAPH_BACKEND=fused_bn_relu``;
   requests of 1, 5 and 32 rows at once; ``compile_count`` is the
   number of buckets; the fused kernel launches exactly 33 times per
   forward (warmup included) under the partition and 0 times without;
   both servers and the hybridized gluon net agree within 1e-5 of the
   largest logit; img/s at b32 on a batch on the card and through
   ``predict()``.
11. ResNet-50 v1 trained through ``gluon.Trainer`` (the usual MXNet
   loop: ``autograd.record``, ``backward``, ``trainer.step(32)``;
   hybridized; SGD lr 0.1, momentum 0.9, wd 1e-4) at full width, b32:
   img/s as ``benchmark_rate`` times it, fp32 (TF32 off) and bf16
   (``net.cast("bfloat16")``, ``multi_precision``); the optimizer's
   launches and device time per ``step`` (torch.profiler) with
   ``fused=True`` and ``fused=False``; from one state, on the same
   gradients, one fused step equal to one loop step bit for bit
   (weights and optimizer states of all 161 trainable tensors, fp32 and
   bf16+mp, two steps); ``save_states`` after 2 steps and
   ``load_states`` into a fresh Trainer, then 2 more steps equal to 4
   uninterrupted steps bit for bit. No flash-attention kernel runs. Phase
   7's parity also holds one Trainer step against the float64 step
   with the fp32 terms of PARITY_LIMITS, and prints whether it equals
   the TrainStep step bit for bit.
12. the attention layer of phase 6 trained through ``gluon.Trainer``
   (adam lr 1e-3, ``multi_precision``, bf16 weights) for 10 steps on one
   batch: K1, K2 and K3 launch once per step, the loss falls; step ms.
13. input pipeline: 512 PNG records of 256x256x3 noise (labels in
   [0, 1000)) and their .idx written with the port's ``recordio``;
   ``DataPipeline`` (4 decode threads, prefetch 2, ``place=True``: pinned
   staging and a side-stream copy to gpu(0)) and ``ImageRecordIter``,
   center crop to 224 and mean/std normalization, each batch on the card
   read back before and after a b32 fp32 ResNet-50 ``TrainStep`` on it and
   held bit for bit against the same source's host pass; the pipeline's
   img/s at 1, 4 and 8 decode threads (random crop and mirror); one
   19.27 MB batch's upload, pinned against pageable, beside the PCIe
   link's bound; ResNet-50 v1 b32 train img/s fed by the pipeline (fp32,
   bf16) and, bf16, by a 4-worker process-pool ``DataLoader``, beside
   phase 7's synthetic img/s, with the data-wait share and
   ``stall_fraction`` of each; the gluon loop (``DataLoader`` with 0 and
   4 workers and ``pin_memory``, ``gluon.Trainer``) at its own
   configuration, its loss falling. The native RecordIO reader must be
   the one that read the records; no kernel of the port launches.
14. checkpoint: ResNet-50 v1 at full width (b32, SGD lr 0.1, momentum
   0.9, wd 1e-4, random weights from seed 0) through
   ``mxnet_tpu_torch.checkpoint``: the bytes of a TrainStep
   ``state_dict``; fp32 TrainStep img/s (one window of 10 steps after 3
   warm ones, a configuration) with no saves, an async ``CheckpointManager.save`` every step and every 10
   steps, and no saves again (``keep_last=2`` in a temporary directory,
   whose free space and filesystem type are printed), with the
   ``checkpoint::snapshot`` ms, the writer's MB/s, write and commit ms
   and ``dropped_saves``, beside a pageable copy of the same state; 4
   TrainStep steps saved each, step 2 restored into a fresh step and 2
   more steps equal to the 4 uninterrupted steps bit for bit (cuDNN
   deterministic; the uninterrupted run repeated as a control); the same
   for a bf16 net with ``multi_precision`` through ``gluon.Trainer``
   (``checkpoint.state_dict`` of net and trainer; the restored weights
   are bfloat16; its state's bytes); a SIGTERM sent from inside a step's
   update loop commits the pre- or post-step state bit for bit; and
   ``examples.train_resume`` SIGTERMed mid-run in a child process,
   restarted, with the same final digest as an uninterrupted run.
15. Module: the same ResNet-50 v1 exported, with
   ``SoftmaxOutput(name="softmax")``, trained through ``Module.fit`` over
   an ``NDArrayIter`` of synthetic b32 batches (fp32, TF32 off; the
   default ``acc`` metric): img/s in benchmark_rate's windows beside
   phase 11's Trainer, and the peak memory of a batch beside the
   Trainer's; one step at batch 8 from the same weights through a
   float64 Module and ``TrainStep(dtype="float64")`` held to
   PARITY_LIMITS' float64 terms; ``module_checkpoint`` after epoch 1,
   ``Module.load`` and ``fit(begin_epoch=1)`` equal to the uninterrupted
   two epochs bit for bit.

16. recurrent: the bucketed LSTM language model of the reference's
   lstm_bucketing.py at its widths (vocabulary 10 000, embedding 200,
   two LSTM layers of 200, batch 32, buckets 10-60; ``LM``) on the
   port's synthetic corpus from SEED: ``BucketingModule.fit`` over
   ``BucketSentenceIter`` (adam lr 0.01, wd 1e-5, ``Perplexity(
   ignore_label=0)``), perplexity scored before and after and held to
   fall by ``LM_PPL_FACTOR``; samples/s and tokens/s overall and per
   bucket; for one b32 batch at T 60 the operator dispatches, CUDA
   launches, device ms and idle share (torch.profiler); one SGD step at
   batch 8, bucket 10, from the trained weights in float64 and fp32 on
   card and host (PARITY_LIMITS' float64 terms, ``LM_PARITY``); the
   gluon path (Embedding, ``gluon.rnn.LSTM`` with dropout 0.2, Dense,
   hybridized, ``gluon.Trainer``) at b32 T35, its loss falling over 10
   steps; ``nd.contrib.foreach`` over an ``LSTMCell(200)`` against a
   one-layer ``LSTM`` with the same weights (outputs and gradients,
   ``RNN_TOL``); a ``sym.contrib`` while_loop and cond bound on card and
   host; the RNN op timed forward and forward + backward at T 35 and 60
   beside ``torch.nn.LSTM`` (cuDNN) with the same weights, whose outputs
   are held to the op's. The loop predicates read on the host are
   counted. No kernel of the port lies on this path.

17. core surface: the operators of ``mxnet_tpu/ops/{elementwise,matrix,
   reduce,nn,random_ops}.py`` that the core surface's first half registers
   (``CORE_SURFACE_NAMES``: 186 names, 130 operators), at the widths of
   the port's models (``SURFACE``): (a) each deterministic operator
   forward, and backward where it has a gradient, on the card against
   the same operator on the host in float64 (the first, the last and one
   row drawn from the seed where the op acts on rows independently), per
   family within ``SURFACE_TOL``
   (exact for data movement, orderings and indices; the indices of an
   ordering on untied rows), one line per family with its count, worst
   share of its limit and the device ms of its largest operator; the
   accumulating operators twice under ``torch.use_deterministic_
   algorithms`` (set, then restored) with equal bits; (b) every RNG
   operator draws 10^6 values on the card, held to its law (KS or
   chi-square, p > ``P_LAW``), and a reseed replays them bit for bit;
   the operators run must be exactly those registered; (c) ResNet-50 v1
   (224x224, 1000 classes, b32, fp32, TF32 off) built under
   ``name_scope`` and initialized with ``MSRAPrelu``, trained 20 steps
   on one batch placed by ``gluon.utils.split_and_load``, with random
   crops (``nd.random.uniform`` offsets, ``nd.slice``) and mirrors
   (``nd.flip``), ``gluon.utils.clip_global_norm``, ``gluon.Trainer``
   (SGD) and ``TopKAccuracy(5)``: the norm equals the host's float64
   norm of the same gradients within 1e-5, ``nd.topk`` of the logits
   equals ``torch.topk``, the loss is finite and falls; its img/s
   beside phase 11's (a reading); (d) the registry's tail
   (``TAIL_SURFACE_NAMES``: the 39 names of ``ops/sequence.py``'s linalg
   half and ``contrib_ops.py``'s FFT, count sketch, index copy, adaptive
   pooling and bilinear resize), each name once at the widths of
   ``TAIL`` on SPD fixtures B B^T / n + I, against the host in float64
   as in (a); ``gelqf`` and ``syevd``, whose signs are not unique,
   held on the card to L Q = A, Q Q^T = I and U^T diag(w) U = A,
   U U^T = I as backward errors (``FACTOR_RESIDUAL_LIMIT``; the card's
   factors rounded to TF32 and to bf16 must fail it), w against the
   host's.

18. model zoo: Inception-v3 (299x299) and AlexNet (224x224), 1000
   classes, trained through ``examples.train_imagenet.benchmark_rate``
   (SGD, two windows of ``ZOO_ITERS`` steps) in fp32 (TF32 off) and bf16 over fp32
   masters, Inception-v3 at b32 and AlexNet at b512 (BASELINE.md's b32
   x 16) and b32 (``ZOO_TRAIN``); VGG-16 and Inception-v3 forward img/s
   at b32 on a batch on the card, fp32 and bf16 (``ZOO_SERVED``); one
   torch.profiler line per new training path (idle share, top device
   ops); beside the reference's published V100 figures, as readings.
   Each family (``ZOO_FAMILIES``: alexnet, vgg11, squeezenet1.1,
   mobilenet1.0, mobilenetv2_1.0, densenet121, inceptionv3) at b2 and
   its standard input: one train-mode forward and backward in float64
   on the card against the host from the same weights (relative L2 of
   logits, gradients and running statistics within ``ZOO_F64_REL_L2``),
   and its hybridized fp32 forward equal to the imperative one. Every
   new gluon layer and loss (``ZOO_LAYERS``, ``ZOO_LOSSES``) and
   ``ctc_loss`` (``ZOO_CTC``; the op and ``gluon.loss.CTCLoss``) on the
   card in fp32 against the host in float64 within ``SURFACE_TOL["nn"]``,
   the worst share of the limit logged; ctc_loss's impossible alignment
   is 1e30 with a zero gradient on both; its CUDA backward (atomics) is
   listed with the spread of its gradient over reruns and whether
   ``torch.use_deterministic_algorithms`` refuses it (phase 17's
   determinism check does not take it); the operators run are the
   slice's registered ones.

19. distribution, each part in ranks started by the port's launcher
   (``parallel.launch``; this process never joins a group; a rank that
   fails fails the phase): (1) NCCL at world size 1: the attention layer
   of phase 6 at its width (b8, T2048, fp32, TF32 off, SGD lr 10,
   momentum 0.9; ``DIST_ATTN``) 5 steps through the dp TrainStep over a
   mesh of the group's one rank, losses and weights bit for bit those
   of today's single-device TrainStep in the same process, step ms of
   both; (2) two ranks sharing the card over gloo, 4 rows each of the
   same batch: losses and weights within tests/test_torch_train_step.py's
   fp32 tolerance of part 1's single-device run, bit for bit across the
   ranks, step ms and K1/K2/K3 launches per rank; then
   ``deterministic_reduction=True``, its ranks bit for bit; which
   collectives gloo takes on CUDA tensors there (one call each); and
   ``ring_self_attention`` over the two ranks on CUDA q/k/v (causal, T
   2048) against ``blockwise_attention`` on one rank, forward and
   gradients, its blocks staged through the host and counted; (3)
   ``-n 2 -s 1``: two workers train ResNet-50 v1 b32 (fp32, TF32 off)
   through ``gluon.Trainer(kvstore="dist_sync")`` (SGD lr 0.025, momentum
   0.9, wd 1e-4; 2 warmup steps, 4 timed; ``DIST_RESNET``), with the
   scheduler and server on the host:
   img/s summed, push ms, pull ms, the server's apply ms and the MB
   pushed per step; the workers' pulled weights bit for bit after every
   step and the loss falling; then ``Module.fit`` over the exported net
   with the same store, 2 batches, its weights bit for bit across the
   workers. One JSON line per part, with the card's name and power
   limit. Labelled one card, N ranks: never a multi-card figure.

20. detection: SSD300-VGG16 (``SSD300``: Liu et al., arXiv:1512.02325,
   as the reference's example/ssd builds it, vgg16_reduced at 300;
   built here from the port's gluon layers as a measurement
   configuration: VGG-16 conv1_1-conv5_3 with pool3 in the "full"
   convention, pool5 3x3 s1 p1, fc6 3x3 dilation 6 of 1024, fc7 1x1 of
   1024, L2Normalization on relu4_3 with a learned scale from 20, four
   extra 1x1/3x3 pairs, maps 38, 19, 10, 5, 3, 1, 8 732 anchors, 21
   classes; MultiBoxTarget with hard-negative mining 3:1; softmax
   cross-entropy over the non-ignored anchors plus smooth-L1, both over
   their count; SGD lr 0.004, momentum 0.9, wd 5e-4; synthetic 300x300
   noise scenes of 1-4 boxes from the seed, no dataset): (1) train img/s
   at b32 through ``gluon.Trainer``, fp32 (TF32 off) and bf16 over fp32
   masters, 3 warmup steps and the median of 5 windows of 8, the loss
   against the targets frozen after the warmup ``SSD300["loss_drop"]``
   lower at the ends of the last two windows than before the first, one
   torch.profiler line each (device ms, idle share, top kernels); (2) one
   float64 step at b2 from the same weights on card and host (relative
   L2 of loss, outputs and gradients within ``ZOO_F64_REL_L2``); (3)
   ``MultiBoxDetection`` (nms_threshold 0.45, nms_topk 400) of a b32
   forward: ms, D1 launched once, the output bit for bit the plain
   route's on the card; (4) ``-n 2 -s 1``: two workers train it (fp32,
   b32 each) through ``gluon.Trainer(kvstore="dist_sync")``, 2 + 2
   steps, img/s summed, push, pull and server-apply ms, the workers bit
   for bit every step, rank 0's losses those of one process stepping on
   both batches' mean gradient (``SSD300["dist_witness_rtol"]``),
   scheduler and server recording CUDA uninitialised; (5) every detection operator (13 operators, the 33
   names of ``DETECTION_NAMES``) once at its model's width on the card
   against the host, both in float64, forward and gradient within
   ``SURFACE_TOL`` (SSD300's priors, targets and detections at b32;
   Proposal over a 38x63 map with the JAX defaults; ROIPooling/ROIAlign
   7x7 over (1, 512, 38, 63) with 300 ROIs; DeformableConvolution 512 ->
   512; R-FCN's deformable PS-ROI; FlowNetC's correlation); (6)
   ``examples.train_rcnn`` 10 steps on the card; then D1 (greedy NMS) at
   the SSD decode's and Proposal's shapes and D2 (ROIPooling forward and
   backward, fp32) against their plain versions on the card: D1's keep
   masks and D2's forward bit for bit, D2's gradient within
   ``D2_BWD_TOL``; times, plain times and bounds.

21. model placement, the ranks started by the port's launcher and
   sharing the card over gloo (NCCL refuses two ranks on one card): (1)
   ResNet-50 v1 b32 fp32 (TF32 off, cuDNN deterministic, SGD at
   ``DIST_RESNET["opt"]``) at ``{"dp": 1, "tp": 2}``, 3 steps, the
   gathered state after each step bit for bit that of a single-device
   TrainStep on the same batch and weights (run first in rank 0); step
   ms beside the single step's, the bytes of weights and optimizer
   state a rank holds against the single step's, peak memory; (2) the
   attention layer of phase 19 (bf16 over fp32 masters) at tp2, K1/K2/K3
   once a step per rank, losses and state within phase 19's tolerances
   of a single-device run (step ms beside it); (3) ResNet-50 at
   ``{"dp": 2, "tp": 2}`` (four ranks, global batch 64, 2 steps) bit
   for bit a ``{"dp": 2}`` run of the same batches (step ms of both),
   then ``state_dict(sharded=True)`` through a four-process
   ``CheckpointManager.save``, restored in rank 0 into a single-device
   TrainStep: its state bit for bit the gathered one, its next loss
   within 1e-5 of dp2 x tp2's; (4) in this process, ``group2ctx``:
   tests/test_executor_groups.py's two-group symbol at ``{dev1:
   gpu(0), dev2: cpu(0)}`` and the reverse against a bind on the card
   (``PLACE_GROUPS_TOL``), outputs and gradients on their groups'
   devices; ``examples.model_parallel_lstm`` with its groups on card,
   host, card, host at phase 16's LM widths (step ms, bytes crossing a
   step) and, over the example's vocabulary of 20, its own check that
   the nll falls (``PLACE_LM``).

22. telemetry and profiling: (1) ResNet-50 v1 b32 bf16 through
   ``TrainStep`` with a ``StepMonitor``, a ``DeviceMemoryMonitor``, a
   ``FlightRecorder`` and a ``GoodputLedger``, and a ``HealthPlane`` on
   the ``/metrics`` server of a free port: over HTTP, ``/readyz`` answers
   200 before the step exists, 503 inside its first step and 200 after
   it; ``/healthz``, ``/metrics``, ``/debug/memory``, ``/debug/goodput``
   and ``POST /debug/bundle`` answer (the bundle names the card);
   memstats' in-use and peak bytes equal ``torch.cuda.memory_allocated``
   and ``max_memory_allocated``; ``POST /debug/xprof`` from another
   thread while this one trains gives one torch.profiler trace holding
   the step's kernels; (2) the attention layer of phase 12 through
   ``gluon.Trainer`` (adam) with a halting ``NumericGuard`` on its
   fused applier: ``TELE_ATTN_STEPS`` steps under
   ``profiler.set_state('run')`` ... ``dump()``, whose chrome trace holds
   exactly as many launches of K1's, K2's and K3's kernels
   (``TELE_KERNELS``) as the port's counters counted, and a kernel
   record for every kernel launch in it (the session's primer takes the
   records torch.profiler drops at a window's start); then one NaN
   gradient: ``NonFiniteError`` names the step and ``mx_nonfinite_total``
   moves by one; (3) the cost of telemetry on part 1's TrainStep: step ms
   and idle share over ``TELE_COST_STEPS`` steps off
   (``telemetry.set_enabled(False)``), at the default, and with
   attribution's device spans on, in two rounds (one in each order); (4)
   ``examples.train_telemetry`` to its own ``ok``; (5) the port's
   telemetry tools, each through its ``main(argv)`` in this process,
   over the files parts 1 and 2 committed: ``diagnose`` over the
   flight recorder's directory, plain and ``--merge``, summarizes every
   bundle, its ``env:`` lines name the card and its ``cuda:0`` lines the
   bundles' bytes; ``goodput_report summary`` prints the wall-clock and
   goodput ratio ``goodput.load_ledger`` reads from the ledger, and
   ``compare`` of the ledger with itself every delta as zero;
   ``profile_tool top`` over part 1's and part 2's collapsed captures
   (``TELE_CAPTURES``: each window's spans through
   ``flamegraph.dump_collapsed``) prints shares summing to at most 100%,
   ``merge -o`` writes a capture whose self time is the two inputs' sum,
   and ``profile_tool diff`` and ``flame_diff`` print the same rows for
   the pair.
23. the multi-model gateway: (1) one ``ModelGateway`` over five models
   registered with warmup (each runs one signature per bucket):
   ResNet-50 v1 fp32 (TF32 off) as an fn model over its weights
   (buckets 1/8/32, two deadline classes), the same weights with
   ``quantize="int8"`` and ``"bf16"``, the same net exported and served
   from its checkpoint through the fused BN+ReLU partition (33 K4a
   launches a forward), and phase 4's causal bf16 flash attention
   (buckets 1/2/4/8, an SLO of ``GW_SLO``); 8 client threads for
   ``GW_LOAD_S`` seconds with requests of 1-8 rows, every response held
   against a direct forward of the same rows (phase 5's bounds; the
   int8 model against the net on its dequantized weights; attention at
   ``kernel_tolerance``); K1 and K4a launches against the batches that
   ran; per model p50/p99, batches, rows, occupancy and bytes held, and
   int8's relative L2 distance from fp32; (2) ``hot_swap`` of the fp32
   model from a ``CheckpointManager`` commit of other weights under 4
   client threads: nothing dropped, both generations served, each
   response within tolerance of its own generation's forward and
   outside it for the other's, the swap's ms; (3) the attention model
   flooded under its SLO: its lowest deadline class sheds, its highest
   and the fp32 model under moderate load drop nothing, the fp32
   model's p50/p99 while attention burns; (4) continuous batching of
   phase 16's LSTM LM (``GW_DECODE``): the continuous loop and the
   static pass on one backend (tokens/s, steps, p99 TTFT), no new
   signature after ``warm()``, every sequence's tokens those of its
   prompt alone, and ``gw.generate`` beside part 1's models; (5) the
   fp32 model with ``mesh_axes={"tp": 2}`` over two gloo ranks on the
   card (``GW_MESH``): each rank's outputs the unsharded model's bit for
   bit, about half the weights' bytes held a rank; (6)
   ``examples.serve_mnist`` to its end.

24. the compile cache, three child processes, each with an empty
   ``_native.BUILD`` (a module attribute set in the child) and the cache
   configured on its own store, each running one main path: the four
   nvcc libraries, phase 10's ResNet-50 checkpoint served once at b32
   through the fused BN+ReLU partition (K4a and K4's launch 33 times;
   its NVRTC program), K1 bf16 at phase 4's bucket 8 and D1 at 32 x 400
   boxes, each against its plain version (the unpartitioned server
   within 1e-5 of its largest logit, ``kernel_tolerance``, bit for bit).
   (1) cold: rank 0 of two ``dist_sync`` ranks (scheduler and server
   started as phase 19 part 3's), with an empty store: every library
   and program compiled, committed (each library with its toolkit
   record) and published; (2) peer: rank 1,
   after a barrier, attaches with prefetch and runs nvcc and NVRTC 0
   times, its prefetched (or pulled) entries as many as rank 0's, its
   K1, K4a and D1 outputs bit for bit rank 0's; (3) warm: a third child
   on rank 0's store, no kvstore: 0 compiles, store hits equal to rank
   0's misses, outputs bit for bit rank 0's. No compile-cache error is
   counted in any, and each child's every launch count is read
   (``CC_LAUNCHES``). The seconds from process start to the first served
   output, the build and NVRTC seconds saved and the entry bytes are
   printed.

25. the sparse path: matrix factorization (``examples.
   train_matrix_factorization.MFNet``: two ``Embedding(sparse_grad=True)``
   tables of rank 128 and their biases) at MovieLens-20M's counts, 138,493
   users and 27,278 items (``SPARSE_MF``; 262,144 synthetic ratings from
   the example's ``synthetic_ratings``, 10% held out, batch 4096, Adam),
   through ``gluon.Trainer`` on the card: (1) after one step, the rows of
   each table that changed, and the rows of its Adam moments that are not
   zero, are exactly the batch's ids, every other row bit for bit its
   start; (2) ``SPARSE_MF["parity_steps"]`` steps on the card from the
   weights carried over as numpy, against the same steps in float64 on
   the host, the touched rows within ``SPARSE_MF_REL_L2`` (relative L2),
   the others unmoved; (3) the example's ``train`` over 2 epochs, its
   validation RMSE falling; (4) samples/s of the lazy path and of the
   same model with ``sparse_grad=False`` (dense Adam over all 165,771
   rows), benchmark_rate's windows, and the host ms a step spends in
   ``dense_to_rsp_device`` and in the per-parameter update; (5)
   ``sparse.dot`` at benchmark/sparse_end2end.py's shape (``SPARSE_DOT``:
   a 128 x 100,000 CSR batch of 32 nonzeros a row times a 100,000 x 16
   weight), plain and with ``transpose_a``, against the host in float64
   within ``SURFACE_TOL["reduce"]``, with its ms; (6) ``LibSVMIter`` over
   a 4096-row file of that shape written here: every CSR batch on
   gpu(0), bit for bit the host iterator's; (7) a step's row-sparse
   gradient and a CSR batch through ``nd.save``/``nd.load`` on the card,
   bit for bit, the file byte for byte the one written from the host,
   and ``row_sparse_pull`` of a batch's rows from a ``device`` store
   holding the user table into a CUDA row-sparse ``out``. No kernel of
   the port launches. Each reading is a JSON line with the card's name
   and power limit.

26. quantization and contrib: (1) tests/test_quantization.py's LeNet on
   its synthetic 4-class images, fed through ``contrib.io.DataLoaderIter``
   over a gluon ``DataLoader`` and trained with ``Module.fit`` on gpu(0)
   (adam, 10 epochs), then ``quantize_model`` with naive calibration over
   100 examples: fp32 accuracy above 0.7, int8 within 0.01 of it, 3 int8
   GEMMs (``INT8_GEMMS``) a forward; (2) ResNet-50 v1 at full width
   (224x224, 1000 classes, fp32, TF32 off, random weights from SEED and
   phase 10's BatchNorm statistics) exported, calibrated on the card
   naive over 128 images (4 batches of 32) and entropy over 32 (seconds;
   54 quantized nodes: 53 convolutions and the classifier), the naive
   run's ranges (its nodes' ``min_data``/``max_data``) held to those of
   the host's naive ``quantize_model`` over the same 128 images
   (``QUANT_RANGE_RTOL``); the
   int8 checkpoint written with ``save_checkpoint`` (54 int8 weights,
   int8 when loaded) and served through ``InferenceServer.from_checkpoint``
   at buckets 1/8/32, plain and with ``MXNET_SUBGRAPH_BACKEND=
   fused_bn_relu``: 54 int8 GEMMs a forward on both, K4a (and K4) 33
   launches a partitioned forward and none plain, each K4a launch of a
   partitioned b32 forward within phase 9's tolerance of its plain
   version; partitioned against plain and the card's logits against the
   host's int8 forward (float64 contractions) on 2 images within the
   host's own int8 distance from its fp32 forward of those images, and
   the card's top-1 the host's on them; int8 img/s at
   b32, plain and partitioned, beside the fp32 checkpoint's; int8 against
   fp32 logits (relative L2, top-1 agreement); (3) the same ResNet-50 as
   a symbolic ``Module`` on gpu(0) with ``mx.sym.Custom`` of a softmax
   registered through ``mx.operator.register`` (NDArray arithmetic, its
   backward p - onehot(label)): ``CUSTOM_STEPS`` SGD steps, each from the
   state it shares with the same Module built with ``SoftmaxOutput``, the
   updates within ``CUSTOM_UPDATE_REL_L2``, every callback array on
   gpu(0), step ms of both; ``mx.nd.Custom`` of a sigmoid under
   ``autograd.record()`` against the closed form and its gradient; (4)
   ``gluon.contrib`` at published widths: a three-layer ConvLSTM
   (``CONVLSTM``: Shi et al. 2015's Moving MNIST setting, 128/64/64
   channels, 5x5 kernels, (16, 16, 16) inputs, 10 frames, b16), 3 SGD
   steps with finite losses and one step's gradients at b2 against the
   host's float64 (``CONTRIB_F64_REL_L2``); ``LSTMPCell(2048, 512)``
   (``LSTMP_NCE``: Jozefowicz et al. 2016) over T 20 at b32 under
   ``VariationalDropoutCell`` into ``NCELoss`` over a 793 471 x 512 table
   with 25 noise samples a position: step ms, peak bytes, one output mask
   for every step, and one step at drop rate 0 against the host's float64
   at a 65 536-row table; ``SparseEmbedding`` at phase 25's user count:
   one ``gluon.Trainer`` Adam step moves exactly the batch's rows. Each
   reading is a JSON line with the card's name and power limit.

27. toolkit (``mx.contrib.text``, ``mx.contrib.svrg_optimization``,
   ``mx.test_utils``, ``mx.monitor``, ``mx.viz`` and the RecordIO file
   tools), each part a path of its own: (1) ``SVRGModule`` over upstream
   example/svrg_module's linear regression at YearPredictionMSD's width
   (90 features, one output, ``LinearRegressionOutput``; ``SVRG_MSD``:
   65 536 synthetic rows, a cut from the dataset's 463 715) at b128 with
   SGD on gpu(0), 4 epochs, ``update_freq`` 2: the stored full gradient
   against the mean of the per-batch gradients at the snapshot
   (``SVRG_FULL_REL_L2``), the first corrected gradient after a snapshot
   against the full one (``SVRG_FIRST_REL_L2``), a corrected gradient
   against the host's float64 formula on the same buffers
   (``SVRG_CORRECTED_REL_L2``), the MSE falling from epoch 0 to 3; an
   SVRG epoch's batches/s beside a plain ``Module``'s and a full pass's
   seconds; (2) ``contrib.text`` (``TEXT``): a GloVe-format file of
   100 000 synthetic tokens at 300 dimensions (glove.840B.300d's width)
   and one at 50, ``GloVe`` and ``CustomEmbedding`` over them, a
   ``Vocabulary`` from ``count_tokens_from_str`` over a synthetic corpus
   and the ``CompositeEmbedding`` of both: every ``idx_to_vec`` on gpu(0)
   and the host matrix bit for bit, ``get_vecs_by_tokens`` the host rows
   bit for bit, a ``gluon.nn.Embedding`` set from ``idx_to_vec`` giving
   those rows on the card; load seconds and the matrices' bytes; (3) the
   test oracles (``ORACLE``) over ``nd.contrib.flash_attention`` in fp32
   (TF32 off): ``check_consistency`` on ``[cpu(0), gpu(0)]`` at (1, 16,
   1024, 64) within ``kernel_tolerance``, ``check_numeric_gradient`` at
   (1, 1, 16, 32) on gpu(0) at the JAX package's tolerances with steps
   of 1e-2 (``ORACLE``), the card's gradients also against the host's
   float64 (``ORACLE_GRAD_REL_L2``), and
   ``check_speed`` of the causal symbol at (8, 16, 2048, 64), ``whole``
   and ``forward``: the whole time may not be below the sum of phase 3's
   fp32 K1, K2 and K3 device times, and K1, K2 and K3 launch at least
   once each (the kernels line's ``test_utils_oracles`` path); (4)
   ``Monitor(1, pattern=".*")`` through ``Module.fit(monitor=)`` on phase
   15's ResNet-50 v1 symbol at b32 for 3 batches: every output reported
   every batch, each statistic mean(|x|) of the output's host copy within
   ``MONITOR_STAT_RTOL``, step ms with and without it; ``print_summary``'s
   total the bound module's parameter count; ``plot_network``'s DOT text
   naming every node but the weights; (5) the file tools on 512
   synthetic 224x224 PNGs in 8 class folders (``FILE_TOOLS``): ``im2rec
   --list``, then ``python -m mxnet_tpu_torch.tools.im2rec --encoding
   .png`` in a child process (PNG through the port's codec, OpenCV or
   not), ``rec2idx`` (its ``.idx`` byte for byte im2rec's) and
   ``rec_shard split`` into 4 balanced shards, the manifest opened by
   ``RecordDataset``, every decoded image its PNG's pixels bit for bit,
   and ResNet-50 v1 b32 trained 4 ``TrainStep`` steps from those
   records with finite losses; pack and feed img/s.

28. the benches of ``mxnet_tpu_torch/tools`` (``TOOLS``), each part a
   path of its own, in this process but for the dist group's scheduler
   and server: (1) ``dispatch_bench`` (10-op chain, 256x256, 200
   iterations) on gpu(0), eager and ``CachedOp`` op/s and µs per op, the
   two chains' sums on the card bit for bit; (2) ``quantized_bench`` at
   its shapes (conv 256 -> 256, 3x3 on 14x14, and FC 2048 -> 1000, b32;
   fp32 with TF32 off against the int8 operators): both rows, int8 GEMMs
   run on the card, and the card's int8 conv and FC outputs against the
   same operators on the host within two float32 roundings of the
   rescale at the host's largest output; (3) ``decode_bench`` over 64
   224x224 PNG records without resize at 0, 2 and 4 decode threads:
   img/s finite and positive, every batch on gpu(0); the JAX tool's JPEG
   workload (resize to 256) where this host has cv2, else the JPEG
   records' refusal naming cv2; (4) ``bandwidth.measure``: the
   ``device`` kvstore on the one card at the tool's three sizes, then a
   ``dist_sync`` group of one scheduler and one server with this process
   its worker, its arrays on the card and then on the host: GB/s
   finite and positive, every pulled first element the 1.0 pushed, the
   device kvstore below HBM's rate. None of the port's kernels launches.

Each path (4, 6, 7, 8, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28) is driven with
every launch count set to 0 just before it and read just after. Then one ``{"kernels": [...]}`` line and,
last, one ``{"ok": true, "device": {...}}`` line. The weights are
random, from a seed. The K1-K3 rows' ``ms``, ``plain_ms`` and
``library_ms`` are CUDA-event medians of 20 single calls after warmup
(``time_ms``), the wrapper's host cost inside the window; their
``device_ms`` and ``library_device_ms`` are device time, the median of 5
windows of 20 calls queued behind a sleep kernel (``time_queued``). The
rtc rows' ``ms`` is ``time_queued`` and their ``ms_host_window`` the
median of back-to-back calls.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
ITERS = 20

# Published dense peaks (NVIDIA data sheets, SXM parts): FLOP/s by
# input dtype and memory bytes/s.
PEAKS = {
    "H100": {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
             "tfloat32": 495e12, "bytes": 3.35e12},
    "H200": {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
             "tfloat32": 495e12, "bytes": 4.8e12},
}


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(*parts):
    print(*parts, flush=True)


def time_ms(fn, iters=ITERS, warmup=3):
    """Median CUDA-event time of `fn` in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_each(fn, reps=10):
    """Median CUDA-event time of one `fn` in milliseconds, from windows
    of `reps` back-to-back calls: a short kernel's host launch cost then
    overlaps the kernels queued before it, as on a served path."""
    def window():
        for _ in range(reps):
            fn()

    return time_ms(window) / reps


_SLEEP_CYCLES_PER_MS = []


def _sleep_cycles_per_ms():
    """Cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    if not _SLEEP_CYCLES_PER_MS:
        torch.cuda._sleep(1000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS.append(1e7 / start.elapsed_time(end))
    return _SLEEP_CYCLES_PER_MS[0]


def time_queued(fn, reps=20, iters=5):
    """Median device time of one `fn` in milliseconds, with the card
    kept ahead of the host: a sleep kernel holds the stream while `reps`
    calls are queued behind the start event, so the window times the
    card running them back to back, not the host's launch cost (which
    bounds time_each for kernels shorter than a launch). A window the
    card reached before the host had queued it all is run again with a
    longer sleep."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycles = int(_sleep_cycles_per_ms() * (2 * host_ms + 1))
    times = []
    while len(times) < iters:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()  # the card still sleeping: all queued
        end.synchronize()
        if ahead:
            times.append(start.elapsed_time(end) / reps)
        else:
            check(cycles < 1e11, "time_queued: the host never got ahead")
            cycles *= 2
    return float(np.median(times))


def attention_bound(card, b, h, tq, tk, d, causal, dtype):
    """Least time (ms) for the work of one attention forward on `card`:
    the larger of FLOPs over the dtype's peak and bytes (Q, K, V, O
    each read or written once, fp32 LSE) over the memory rate."""
    peaks = PEAKS["H200" if "H200" in card else "H100"]
    elt = torch.tensor([], dtype=dtype).element_size()
    flops = 4.0 * b * h * tq * tk * d * (0.5 if causal and tq == tk else 1.0)
    nbytes = (2 * tq + 2 * tk) * b * h * d * elt + 4 * b * h * tq
    t_ops = flops / peaks[str(dtype).split(".")[1]]
    t_bytes = nbytes / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops, nbytes


def backward_bound(card, b, h, tq, tk, d, causal, dtype, which):
    """Least time (ms) for one backward kernel's work: K2 ("dkv") does
    8 and K3 ("dq") 6 FLOP per (query, key, head-dim) triple (two dot
    products and two or one updates), halved for causal; bytes are Q,
    K, V, dO read and the fp32 LSE and delta, plus dK and dV (K2) or dQ
    (K3) written, each once."""
    peaks = PEAKS["H200" if "H200" in card else "H100"]
    elt = torch.tensor([], dtype=dtype).element_size()
    per = 8.0 if which == "dkv" else 6.0
    flops = per * b * h * tq * tk * d * (0.5 if causal and tq == tk
                                         else 1.0)
    reads = (2 * tq + 2 * tk) * b * h * d * elt + 2 * 4 * b * h * tq
    writes = (2 * tk if which == "dkv" else tq) * b * h * d * elt
    nbytes = reads + writes
    t_ops = flops / peaks[str(dtype).split(".")[1]]
    t_bytes = nbytes / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops, nbytes


def max_violation(got, want, rtol, atol):
    """max(|got - want| - (atol + rtol |want|)); <= 0 means within."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def _relative(arrays, prefix):
    """{relative name: array}: parameter names without the net's prefix
    and with block counters renumbered, so two nets built in one process
    match (gluon.utils.relative_names)."""
    from mxnet_tpu_torch.gluon.utils import relative_names

    rel = relative_names(list(arrays), prefix)
    return {rel[n]: v for n, v in arrays.items()}


def _step_state_errors(card_state, host_state, w0):
    """Per tensor, max |(card - w0) - (host - w0)| / max |host - w0|: the
    error of the card's update relative to the host's."""
    out = {}
    for n, host in host_state.items():
        step = host - w0[n]
        scale = float(np.abs(step).max())
        out[n] = float(np.abs(card_state[n] - host).max()) / max(scale,
                                                                  1e-30)
    return out


# -- phases -------------------------------------------------------------------

def phase_device():
    check(torch.cuda.is_available(), "no CUDA device: chip_smoke.py runs "
          "on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log("card:", smi)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0])
    # The plain versions and the fp32 comparisons are strict fp32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# Every attention kernel of the port, as ptxas names its instantiations
# (mangled: the name, then the template arguments: the dtype, where the
# kernel has one, and the head dim).
ATTENTION_KERNELS = {
    "flash_fwd_3xtf32_kernel": ("f",),
    "flash_fwd_wgmma_kernel": ("13__nv_bfloat16", "6__half"),
    "flash_bwd_dkv_3xtf32_kernel": ("f",),
    "flash_bwd_dkv_wgmma_kernel": ("13__nv_bfloat16", "6__half"),
    "flash_bwd_dq_3xtf32_kernel": ("f",),
    "flash_bwd_dq_wgmma_kernel": ("13__nv_bfloat16", "6__half"),
    "flash_split_tf32_kernel": ("f",),  # the fp32 K1-K3's pre-pass
}


def _instantiation(entry):
    """(kernel, dtype, head_dim) of a mangled attention entry, or None."""
    m = re.search(r"\d+(flash_\w+?_kernel)I(f|13__nv_bfloat16|6__half)?"
                  r"Li(\d+)E", entry or "")
    if not m or m.group(1) not in ATTENTION_KERNELS:
        return None
    return m.group(1), m.group(2) or "f", int(m.group(3))


def phase_build():
    """Build every source; fail on a missing attention instantiation or
    on a spill in any attention kernel at any head dim."""
    from mxnet_tpu_torch import _native

    t0 = time.perf_counter()
    _native.build()
    seconds = time.perf_counter() - t0
    spills, seen = [], set()
    for name in _native.SOURCES:
        lines = _native.build_log(name).splitlines()
        regs = [ln.strip() for ln in lines if "registers" in ln]
        log("built %s: %d kernel instantiations" % (name, len(regs)))
        entry = None
        for ln in lines:
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1] if "'" in ln else ln
                inst = _instantiation(entry)
                if inst:
                    seen.add(inst)
            elif "registers" in ln:
                log("  ", _instantiation(entry) or entry, ln.strip())
            elif "spill" in ln and \
                    "0 bytes spill stores, 0 bytes spill loads" not in ln:
                log("   spills in %s: %s" % (entry, ln.strip()))
                inst = _instantiation(entry)
                if inst:
                    spills.append("%s: %s" % (inst, ln.strip()))
    want = {(k, t, d) for k, types in ATTENTION_KERNELS.items()
            for t in types for d in (32, 64, 128)}
    log("build_seconds", round(seconds, 3))
    check(want <= seen, "attention instantiations missing from the ptxas "
          "report: %s" % sorted(want - seen))
    check(not spills, "ptxas reports register spills in attention "
          "kernels:\n" + "\n".join(spills))


# bf16/fp16 cases of the tensor-core kernels (K1, K2, K3): the training
# geometry at head dims 64 and 128, non-causal T 2048 (where P's rounding
# to the dtype shows most), ragged T (200, 1000: no multiple of a 64- or
# 128-row tile), Tq 256 against Tk 512, and head dim 32 (64-byte
# swizzle), causal and not.
WGMMA_CASES = [
    ((2, 16, 2048, 64), (2, 16, 2048, 64), True),
    ((2, 16, 2048, 128), (2, 16, 2048, 128), True),
    ((1, 4, 2048, 64), (1, 4, 2048, 64), False),
    ((2, 3, 200, 64), (2, 3, 200, 64), True),
    ((1, 4, 1000, 128), (1, 4, 1000, 128), False),
    ((1, 4, 1000, 64), (1, 4, 1000, 64), True),
    ((1, 4, 256, 64), (1, 4, 512, 64), True),
    ((1, 4, 256, 128), (1, 4, 512, 128), False),
    ((2, 3, 200, 32), (2, 3, 200, 32), True),
    ((1, 4, 1000, 32), (1, 4, 1000, 32), False),
    ((1, 4, 256, 32), (1, 4, 512, 32), True),
]

# The kernel each dtype runs (the kernels line names it per entry).
DESIGN = {
    "flash_attention_fwd": {"bfloat16": "wgmma+tma", "float16": "wgmma+tma",
                            "float32": "3xtf32 wgmma+tma, split pre-pass"},
    "flash_attention_bwd_dkv": {"bfloat16": "wgmma+tma",
                                "float16": "wgmma+tma",
                                "float32": "3xtf32 wgmma+tma, split pre-pass"},
    "flash_attention_bwd_dq": {"bfloat16": "wgmma+tma",
                               "float16": "wgmma+tma",
                               "float32": "3xtf32 wgmma+tma, split pre-pass"},
}


def phase_kernels(card):
    """Flash-attention forward kernel against its plain version."""
    from mxnet_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(shape_q, shape_k, dtype):
        return tuple(torch.randn(s, generator=gen, device="cuda").to(dtype)
                     for s in (shape_q, shape_k, shape_k))

    # Tolerances: fa.kernel_tolerance; LSE is fp32 in both versions.
    cases = [
        ((1, 4, 512, 64), (1, 4, 512, 64), torch.float32, True),
        ((1, 4, 512, 64), (1, 4, 512, 64), torch.float32, False),
        ((1, 4, 256, 64), (1, 4, 512, 64), torch.float32, False),
        ((1, 4, 256, 64), (1, 4, 512, 64), torch.float32, True),
    ]
    cases += [(sq, sk, dt, causal)
              for dt in (torch.float32, torch.bfloat16, torch.float16)
              for sq, sk, causal in WGMMA_CASES]
    launches0 = fa.LAUNCHES
    calls = 0
    by_dtype = {}
    for shape_q, shape_k, dt, causal in cases:
        q, k, v = inputs(shape_q, shape_k, dt)
        blocks = dict(block_q=shape_q[2], block_k=shape_k[2])
        out, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                              **blocks)
        calls += 1
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_reference(q, k, v,
                                                        causal=causal,
                                                        **blocks)
        rtol, atol = fa.kernel_tolerance(dt, ref_out)
        _fold_error(by_dtype, dt, out, ref_out, rtol, atol)
        lse_tol = (rtol, atol) if dt == torch.float32 else (1e-4, 1e-4)
        v_out = max_violation(out, ref_out, rtol, atol)
        v_lse = max_violation(lse, ref_lse, *lse_tol)
        log(json.dumps({
            "check": "flash_attention_fwd vs plain", "q": shape_q,
            "k": shape_k, "dtype": str(dt).split(".")[1], "causal": causal,
            "max_abs_err_out": float((out.float() - ref_out.float())
                                     .abs().max()),
            "max_abs_err_lse": float((lse - ref_lse).abs().max()),
            "rtol": rtol, "atol": atol, "lse_tol": lse_tol,
            "within": v_out <= 0 and v_lse <= 0}))
        check(v_out <= 0 and v_lse <= 0,
              "flash_attention_fwd disagrees with its plain version at "
              "%s/%s %s causal=%s" % (shape_q, shape_k, dt, causal))
    check(fa.LAUNCHES - launches0 == calls,
          "LAUNCHES rose by %d for %d calls" % (fa.LAUNCHES - launches0,
                                                calls))
    log(json.dumps({"check": "flash_attention_fwd: largest share of "
                    "kernel_tolerance per dtype", "by_dtype": by_dtype}))

    # The serving shape: bucket 8 of the served attention function.
    b, h, t, d, dt = 8, 16, 2048, 64, torch.bfloat16
    q, k, v = inputs((b, h, t, d), (b, h, t, d), dt)
    out, _ = fa.flash_attention_forward(q, k, v, causal=True)
    ref_out, _ = fa.flash_attention_reference(q, k, v, causal=True)
    err = float((out.float() - ref_out.float()).abs().max())
    check(max_violation(out, ref_out, *fa.kernel_tolerance(dt, ref_out))
          <= 0,
          "flash_attention_fwd disagrees at the serving shape")
    # One call at a time (time_ms), the wrapper's host cost (checks,
    # three tensor maps) inside the window; and device time
    # (time_queued), which at a quarter of a millisecond differs.
    def kernel():
        return fa.flash_attention_forward(q, k, v, causal=True)

    def library():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    kernel_ms, device_ms = time_ms(kernel), time_queued(kernel)
    plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v,
                                                            causal=True))
    library_ms, library_device_ms = time_ms(library), time_queued(library)
    bound_ms, bound_by, flops, nbytes = attention_bound(
        card, b, h, t, t, d, True, dt)
    # The fp32 (split-TF32) kernel at the same shape, on fp32 inputs (all
    # 24 bits random, so hi and lo both count), held against its plain
    # version and timed beside its FFMA and 3xTF32 bounds and SDPA's fp32
    # forward (TF32 off).
    q32, k32, v32 = inputs((b, h, t, d), (b, h, t, d), torch.float32)

    def kernel32():
        return fa.flash_attention_forward(q32, k32, v32, causal=True)

    def library32():
        return F.scaled_dot_product_attention(q32, k32, v32, is_causal=True)

    out32, lse32 = kernel32()
    ref32, ref_lse32 = fa.flash_attention_reference(q32, k32, v32,
                                                    causal=True)
    tol32 = fa.kernel_tolerance(torch.float32, ref32)
    _fold_error(by_dtype, torch.float32, out32, ref32, *tol32)
    v_out = max_violation(out32, ref32, *tol32)
    v_lse = max_violation(lse32, ref_lse32, *tol32)
    log(json.dumps({
        "check": "flash_attention_fwd vs plain at the serving shape",
        "q": [b, h, t, d], "dtype": "float32", "causal": True,
        "max_abs_err_out": float((out32 - ref32).abs().max()),
        "max_abs_err_lse": float((lse32 - ref_lse32).abs().max()),
        "tol": tol32, "within": v_out <= 0 and v_lse <= 0}))
    check(v_out <= 0 and v_lse <= 0, "flash_attention_fwd disagrees with "
          "its plain version in fp32 at the serving shape")
    del out32, lse32, ref32, ref_lse32
    fp32_ms = time_ms(kernel32)
    plain32_ms = time_ms(lambda: fa.flash_attention_reference(
        q32, k32, v32, causal=True), iters=5)
    fp32 = fp32_row(card, fp32_ms, time_queued(kernel32), plain32_ms,
                    attention_bound(card, b, h, t, t, d, True,
                                    torch.float32),
                    time_ms(library32), time_queued(library32),
                    "F.scaled_dot_product_attention, fp32")
    fp32["device_ms_by_kernel"] = _device_ms_by_kernel(kernel32)
    del q32, k32, v32
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "mxnet_tpu/ops/pallas_attention.py:119",
        "launches": None, "max_abs_err": err,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "device_ms": device_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "library_device_ms": library_device_ms,
        "design": DESIGN["flash_attention_fwd"],
        "fp32_ms": fp32_ms, "fp32": fp32,
        "bound_share": bound_ms / kernel_ms,
        "max_abs_err_by_dtype": by_dtype,
        "shape": [b, h, t, d], "dtype": "bfloat16", "causal": True,
        "flops": flops, "bytes": nbytes,
        "achieved_tflops": flops / kernel_ms / 1e9,
    }


def fp32_row(card, ms, device_ms, plain_ms, bound, library_ms,
             library_device_ms, library_call):
    """The reading of an attention kernel's fp32 route: its time one
    call at a time and on the device, its plain version's time on the
    same fp32 inputs, its bound (operations over the fp32 FFMA peak or
    bytes over the memory rate, the larger), the 3xTF32 bound (three
    times the operations over the TF32 tensor-core peak, or the bytes),
    and the library call's times at the same shape."""
    bound_ms, bound_by, flops, nbytes = bound
    peaks = PEAKS["H200" if "H200" in card else "H100"]
    tf32_ms = max(3 * flops / peaks["tfloat32"],
                  nbytes / peaks["bytes"]) * 1e3
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / device_ms, "bound_3xtf32_ms": tf32_ms,
            "bound_3xtf32_share": tf32_ms / device_ms,
            "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "library_call": library_call, "flops": flops, "bytes": nbytes,
            "achieved_tflops": flops / device_ms / 1e9}


def _device_ms_by_kernel(fn, reps=5):
    """Device ms per call of `fn` by CUDA kernel (torch.profiler), keyed
    by the kernel's name up to its template arguments: how a launcher's
    time splits between its kernels (the fp32 route's pre-pass and main
    kernel)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if str(evt.device_type).endswith("CUDA"):
            name = evt.key.replace("(anonymous namespace)::", "")
            name = re.split(r"[<(]", re.sub(r"^void ", "", name))[0]
            name = name.split("::")[-1]
            out[name] = out.get(name, 0.0) + \
                evt.self_device_time_total / 1e3 / reps
    return out


def _fold_error(by_dtype, dtype, got, want, rtol, atol):
    """Folds one comparison into {dtype: {max_abs_err, max_share}}:
    max_share is the largest |err| / (atol + rtol |want|) seen, the
    fraction of the tolerance used."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    share = float((err / (atol + rtol * want.abs())).max())
    cur = by_dtype.setdefault(str(dtype).split(".")[1],
                              {"max_abs_err": 0.0, "max_share": 0.0})
    cur["max_abs_err"] = max(cur["max_abs_err"], float(err.max()))
    cur["max_share"] = max(cur["max_share"], share)


def _hold_backward(names, got, want, errs, where):
    """Log and hold each gradient against its plain version
    (``kernel_tolerance``); folds the largest errors into `errs`. True
    if all are within."""
    from mxnet_tpu_torch.ops.flash_attention import kernel_tolerance

    res = {}
    for name, g_, w in zip(names, got, want):
        rtol, atol = kernel_tolerance(w.dtype, w)
        res[name] = (float((g_.float() - w.float()).abs().max()),
                     max_violation(g_, w, rtol, atol), rtol, atol)
    errs["dq"] = max(errs["dq"], res["dq"][0])
    errs["dkv"] = max(errs["dkv"], res["dk"][0], res["dv"][0])
    within = all(r[1] <= 0 for r in res.values())
    log(json.dumps(dict(
        {"check": "flash_attention_bwd (K2, K3) vs plain",
         "dtype": str(want[0].dtype).split(".")[1]}, **where,
        max_abs_err={n: r[0] for n, r in res.items()},
        tol={n: [r[2], r[3]] for n, r in res.items()}, within=within)))
    return within


def phase_backward_kernels(card):
    """K2 (dK/dV) and K3 (dQ), through the autograd.Function, against
    the plain backward; peak memory; timings at the training shape."""
    from mxnet_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)

    def inputs(shape_q, shape_k, dtype):
        return tuple(torch.randn(s, generator=gen, device="cuda").to(dtype)
                     for s in (shape_q, shape_k, shape_k, shape_q))

    # Tolerances: fa.kernel_tolerance. fp32 at every head dim the kernels
    # take (each has its own tiles), and fp32 (K2 and K3 split TF32),
    # bf16 and fp16 at WGMMA_CASES.
    cases = [
        ((1, 4, 512, 64), (1, 4, 512, 64), torch.float32, True),
        ((1, 4, 512, 64), (1, 4, 512, 64), torch.float32, False),
        ((1, 4, 256, 64), (1, 4, 512, 64), torch.float32, False),
        ((1, 4, 256, 64), (1, 4, 512, 64), torch.float32, True),
        ((1, 4, 512, 128), (1, 4, 512, 128), torch.float32, True),
        ((1, 4, 256, 128), (1, 4, 512, 128), torch.float32, False),
        ((1, 4, 512, 32), (1, 4, 512, 32), torch.float32, True),
    ]
    cases += [(sq, sk, dt, causal)
              for dt in (torch.float32, torch.bfloat16, torch.float16)
              for sq, sk, causal in WGMMA_CASES]
    errs = {"dkv": 0.0, "dq": 0.0}
    by_dtype = {"dkv": {}, "dq": {}}
    floor_share = {}  # dtype: the largest atol floor / atol, dq and dk
    for shape_q, shape_k, dt, causal in cases:
        q, k, v, g = inputs(shape_q, shape_k, dt)
        blocks = dict(block_q=shape_q[2], block_k=shape_k[2])
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = (fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ)
        fa.flash_attention(*leaves, causal=causal, **blocks).backward(g)
        torch.cuda.synchronize()
        check((fa.LAUNCHES_BWD_DKV - before[0], fa.LAUNCHES_BWD_DQ
               - before[1]) == (1, 1), "backward did not launch K2 and K3 "
              "once each")
        out, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                              **blocks)
        want = fa.flash_attention_backward_reference(q, k, v, out, lse, g,
                                                     causal=causal, **blocks)
        for which, got_w, want_w in (("dq", leaves[0].grad, want[0]),
                                     ("dkv", leaves[1].grad, want[1]),
                                     ("dkv", leaves[2].grad, want[2])):
            _fold_error(by_dtype[which], dt, got_w, want_w,
                        *fa.kernel_tolerance(dt, want_w))
        if dt != torch.float32:
            # The floor for gradients that are exactly zero must not
            # loosen this comparison: below the atol it already has.
            floors = fa.backward_atol_floor(q, k, v, g, lse, causal)
            share = max(f / fa.kernel_tolerance(dt, w)[1]
                        for f, w in zip(floors[:2], want[:2]))
            name = str(dt).split(".")[1]
            floor_share[name] = max(floor_share.get(name, 0.0), share)
            check(share < 1, "the atol floor would loosen the %s backward "
                  "comparison at %s/%s causal=%s (share %.3g)"
                  % (name, shape_q, shape_k, causal, share))
        within = _hold_backward(("dq", "dk", "dv"),
                                [t.grad for t in leaves], want, errs,
                                dict(q=shape_q, k=shape_k, causal=causal))
        check(within, "backward kernels disagree with the plain version at "
              "%s/%s %s causal=%s" % (shape_q, shape_k, dt, causal))
    log(json.dumps({"check": "flash_attention_bwd: largest share of "
                    "kernel_tolerance per dtype", "by_dtype": by_dtype,
                    "atol_floor_share": floor_share}))

    # The training shape of the attention layer.
    b, h, t, d, dt = 8, 16, 2048, 64, torch.bfloat16
    q, k, v, g = inputs((b, h, t, d), (b, h, t, d), dt)
    out, lse = fa.flash_attention_forward(q, k, v, causal=True)
    delta = (g.float() * out.float()).sum(-1).contiguous()
    torch.cuda.synchronize()
    score_bytes = 4 * b * h * t * t
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fa.flash_attention_backward(q, k, v, out, lse, g, causal=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    log(json.dumps({"check": "backward peak memory", "shape": [b, h, t, d],
                    "peak_bytes_above_inputs": peak,
                    "fp32_score_matrix_bytes": score_bytes}))
    check(peak < score_bytes, "backward peak memory %d >= one fp32 score "
          "matrix %d" % (peak, score_bytes))

    # K2 and K3 at this shape against their plain versions.
    got_dk, got_dv = fa.launch_bwd_dkv(q, k, v, g, lse, delta, True,
                                       d ** -0.5)
    got_dq = fa.launch_bwd_dq(q, k, v, g, lse, delta, True, d ** -0.5)
    torch.cuda.synchronize()
    want_dk, want_dv = fa.flash_attention_bwd_dkv_reference(
        q, k, v, out, lse, g, causal=True)
    want_dq = fa.flash_attention_bwd_dq_reference(q, k, v, out, lse, g,
                                                  causal=True)
    within = _hold_backward(("dq", "dk", "dv"), (got_dq, got_dk, got_dv),
                            (want_dq, want_dk, want_dv), errs,
                            dict(q=[b, h, t, d], k=[b, h, t, d],
                                 causal=True, launched="directly"))
    check(within, "backward kernels disagree with the plain version at the "
          "training shape")
    del got_dk, got_dv, got_dq, want_dk, want_dv, want_dq

    # One call at a time and device time, as for K1.
    def dkv():
        return fa.launch_bwd_dkv(q, k, v, g, lse, delta, True, d ** -0.5)

    def dq():
        return fa.launch_bwd_dq(q, k, v, g, lse, delta, True, d ** -0.5)

    dkv_ms, dq_ms = time_ms(dkv), time_ms(dq)
    device_ms = {"dkv": time_queued(dkv), "dq": time_queued(dq)}
    plain_dkv_ms = time_ms(lambda: fa.flash_attention_bwd_dkv_reference(
        q, k, v, out, lse, g, causal=True), iters=5)
    plain_dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq_reference(
        q, k, v, out, lse, g, causal=True), iters=5)
    # Yardstick, never called by the port: the backward of PyTorch's
    # fused attention (dq, dk and dv in one call) on a retained graph.
    lq, lk, lv = (x.detach().clone().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    def library():
        return torch.autograd.grad(lib_out, (lq, lk, lv), g,
                                   retain_graph=True)

    library_ms, library_device_ms = time_ms(library), time_queued(library)
    # The fp32 kernels at the same shape (K2 and K3 split TF32), as for
    # K1: fp32 inputs, an fp32 forward's LSE and delta, held against their
    # plain versions, then timed beside their FFMA and 3xTF32 bounds and
    # SDPA's fp32 backward (TF32 off), each launcher's pre-pass and kernel
    # apart.
    q32, k32, v32, g32 = inputs((b, h, t, d), (b, h, t, d), torch.float32)
    out32, lse32 = fa.flash_attention_forward(q32, k32, v32, causal=True)
    delta32 = (g32 * out32).sum(-1).contiguous()
    kernels32 = {
        "dkv": lambda: fa.launch_bwd_dkv(q32, k32, v32, g32, lse32, delta32,
                                         True, d ** -0.5),
        "dq": lambda: fa.launch_bwd_dq(q32, k32, v32, g32, lse32, delta32,
                                       True, d ** -0.5)}
    plain32 = {
        "dkv": fa.flash_attention_bwd_dkv_reference,
        "dq": fa.flash_attention_bwd_dq_reference}
    got_dk, got_dv = kernels32["dkv"]()
    got_dq = kernels32["dq"]()
    want_dk, want_dv = plain32["dkv"](q32, k32, v32, out32, lse32, g32,
                                      causal=True)
    want_dq = plain32["dq"](q32, k32, v32, out32, lse32, g32, causal=True)
    for which, got_w, want_w in (("dq", got_dq, want_dq),
                                 ("dkv", got_dk, want_dk),
                                 ("dkv", got_dv, want_dv)):
        _fold_error(by_dtype[which], torch.float32, got_w, want_w,
                    *fa.kernel_tolerance(torch.float32, want_w))
    within = _hold_backward(("dq", "dk", "dv"), (got_dq, got_dk, got_dv),
                            (want_dq, want_dk, want_dv), errs,
                            dict(q=[b, h, t, d], k=[b, h, t, d],
                                 causal=True, launched="directly"))
    check(within, "fp32 backward kernels disagree with the plain version "
          "at the training shape")
    del got_dk, got_dv, got_dq, want_dk, want_dv, want_dq
    fp32_ms = {w: time_ms(fn) for w, fn in kernels32.items()}
    plain32_ms = {w: time_ms(lambda fn=fn: fn(q32, k32, v32, out32, lse32,
                                              g32, causal=True), iters=5)
                  for w, fn in plain32.items()}
    lq, lk, lv = (x.detach().clone().requires_grad_() for x in (q32, k32,
                                                                  v32))
    lib_out32 = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)

    def library32():
        return torch.autograd.grad(lib_out32, (lq, lk, lv), g32,
                                   retain_graph=True)

    lib32_ms, lib32_device_ms = time_ms(library32), time_queued(library32)
    fp32 = {w: fp32_row(card, fp32_ms[w], time_queued(fn), plain32_ms[w],
                        backward_bound(card, b, h, t, t, d, True,
                                       torch.float32, w),
                        lib32_ms, lib32_device_ms,
                        "backward of F.scaled_dot_product_attention, fp32 "
                        "(dq, dk and dv together)")
            for w, fn in kernels32.items()}
    for w, fn in kernels32.items():
        fp32[w]["device_ms_by_kernel"] = _device_ms_by_kernel(fn)
    del q32, k32, v32, g32, out32, lse32, delta32, lq, lk, lv, lib_out32
    entries = []
    for name, which, ms, plain_ms, replaces in (
            ("flash_attention_bwd_dkv", "dkv", dkv_ms, plain_dkv_ms,
             "mxnet_tpu/ops/pallas_attention.py:262"),
            ("flash_attention_bwd_dq", "dq", dq_ms, plain_dq_ms,
             "mxnet_tpu/ops/pallas_attention.py:281")):
        bound_ms, bound_by, flops, nbytes = backward_bound(
            card, b, h, t, t, d, True, dt, which)
        entries.append({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": replaces, "launches": None,
            "max_abs_err": errs[which], "ms": ms, "kernel_ms": ms,
            "device_ms": device_ms[which],
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "library_call": "backward of F.scaled_dot_product_attention "
                            "(dq, dk and dv together)",
            "design": DESIGN[name], "fp32_ms": fp32_ms[which],
            "fp32": fp32[which],
            "bound_share": bound_ms / ms,
            "max_abs_err_by_dtype": by_dtype[which],
            "shape": [b, h, t, d], "dtype": "bfloat16", "causal": True,
            "flops": flops, "bytes": nbytes,
            "achieved_tflops": flops / ms / 1e9,
            "backward_peak_bytes": peak})
    return entries


def phase_attention_served():
    """The registered op served through InferenceServer: requests are
    fp32 (q, k, v) packs, cast to bf16 on the card inside the function."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd, serving
    from mxnet_tpu_torch.ops import flash_attention as fa

    def attn(x):
        xb = x.astype("bfloat16")
        return nd.contrib.flash_attention(xb[:, 0], xb[:, 1], xb[:, 2],
                                          causal=True)

    item = (3, 16, 2048, 64)
    rng = np.random.default_rng(SEED)
    rows = [1, 2, 3, 1, 2, 3]
    reqs = [rng.standard_normal((r,) + item, dtype=np.float32) for r in rows]

    fa.LAUNCHES = 0  # the main path starts here
    srv = serving.InferenceServer(attn, item_shape=item, buckets=(1, 2, 4, 8),
                                  max_delay_ms=20, ctx=mx.gpu(0))
    try:
        check(srv.compile_count == 4, "warmup ran %d signatures, not 4"
              % srv.compile_count)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(reqs)) as pool:
            futs = list(pool.map(srv.submit, reqs))
        outs = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
    finally:
        srv.shutdown()
    launches = fa.LAUNCHES  # read just after the path
    batches = srv.metrics.total_batches
    check(launches == 4 + batches,
          "flash_attention_fwd launched %d times for 4 warmup and %d served "
          "batches" % (launches, batches))
    for r, o in zip(rows, outs):
        check(o.shape == (r, 16, 2048, 64), "served shape %s" % (o.shape,))
        check(bool(torch.isfinite(o.data_.float()).all()),
              "non-finite served output")
    x = torch.from_numpy(reqs[2]).cuda().to(torch.bfloat16)
    ref, _ = fa.flash_attention_reference(
        x[:, 0].contiguous(), x[:, 1].contiguous(), x[:, 2].contiguous(),
        causal=True)
    err = float((outs[2].data_.float() - ref.float()).abs().max())
    check(max_violation(outs[2].data_, ref,
                        *fa.kernel_tolerance(ref.dtype, ref)) <= 0,
          "served attention disagrees with the plain version (%g)" % err)
    log(json.dumps({"phase": "attention_served", "requests": len(rows),
                    "rows": sum(rows), "batches": batches,
                    "launches": launches, "max_abs_err_vs_plain": err,
                    "wall_s": wall, "stats": srv.stats()}))
    return launches


def phase_resnet_served():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd, serving
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.gluon.parameter import override
    from mxnet_tpu_torch.gluon.utils import params_from_numpy
    from mxnet_tpu_torch.ops import flash_attention as fa

    log("tf32: cudnn.allow_tf32=%s cuda.matmul.allow_tf32=%s (strict fp32 "
        "for the host comparison and the fp32 img/s)"
        % (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32))
    fa.LAUNCHES = 0
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=mx.gpu(0))
    net.hybridize()
    item = (3, 224, 224)
    buckets = (1, 8, 32)

    def fp32_fn(x):
        return net(x)

    srv32 = serving.InferenceServer(fp32_fn, item_shape=item,
                                    buckets=buckets, max_delay_ms=5)
    pobjs = list(net.collect_params().values())
    bf16_params = [p.data().astype("bfloat16") for p in pobjs]

    def bf16_fn(*args):
        *weights, x = args
        with override(dict(zip(pobjs, weights))):
            return net(x.astype("bfloat16"))

    srv16 = serving.InferenceServer(bf16_fn, bf16_params, item_shape=item,
                                    buckets=buckets, max_delay_ms=5)
    rng = np.random.default_rng(SEED)
    rows = [1, 2, 3, 4, 1, 2, 3, 4]
    reqs = [rng.random((r,) + item, dtype=np.float32) for r in rows]
    result = {"phase": "resnet50_v1_served"}
    try:
        for tag, srv in (("fp32", srv32), ("bf16", srv16)):
            check(srv.compile_count == len(buckets),
                  "%s warmup ran %d signatures" % (tag, srv.compile_count))
            with ThreadPoolExecutor(len(reqs)) as pool:
                futs = list(pool.map(srv.submit, reqs))
            outs = [f.result(timeout=300) for f in futs]
            for r, o in zip(rows, outs):
                check(o.shape == (r, 1000), "served shape %s" % (o.shape,))
                check(bool(np.isfinite(o.asnumpy()).all()),
                      "non-finite %s output" % tag)
            result[tag] = {"batches": srv.metrics.total_batches,
                           "stats": srv.stats()}

        # fp32 on the card against the same net on the host.
        x2 = reqs[1]
        got32 = srv32.predict(x2).asnumpy()
        got16 = srv16.predict(x2).asnumpy()
        with mx.cpu():
            host = vision.resnet50_v1(classes=1000)
            host.initialize()
            params_from_numpy(host, {p.name: p.data().asnumpy()
                                     for p in pobjs}, prefix=net.prefix)
            with autograd.pause():
                want = host(nd.array(x2)).asnumpy()
        scale = float(np.abs(want).max())
        err32 = float(np.abs(got32 - want).max())
        rel16 = float(np.abs(got16 - want).max()) / scale
        result["host_check"] = {"images": 2, "max_abs_ref": scale,
                                "fp32_max_abs_err": err32,
                                "fp32_limit": 1e-3 * scale,
                                "bf16_rel_err": rel16}
        check(err32 <= 1e-3 * scale,
              "fp32 served output differs from the host run: %g > %g"
              % (err32, 1e-3 * scale))
        # bf16 keeps 8 mantissa bits through 53 layers; a loose check
        # that it computes the same function.
        check(rel16 <= 0.1, "bf16 output too far from fp32: %g" % rel16)

        # img/s at batch 32: the served function on a batch already on
        # the card (the bench's inference row), and end to end through
        # predict() with host requests.
        batch = nd.array(rng.random((32,) + item, dtype=np.float32),
                         ctx=mx.gpu(0))

        def forward(fn, params):
            with torch.no_grad(), autograd.pause():
                fn(*params, batch).wait_to_read()

        host32 = rng.random((32,) + item, dtype=np.float32)
        for tag, fn, params, srv in (("fp32", fp32_fn, [], srv32),
                                     ("bf16", bf16_fn, bf16_params, srv16)):
            ms = time_ms(lambda: forward(fn, params))
            t0 = time.perf_counter()
            for _ in range(ITERS):
                srv.predict(host32).wait_to_read()
            served_s = (time.perf_counter() - t0) / ITERS
            result[tag].update({"forward_ms_b32": ms,
                                "forward_img_s_b32": 32e3 / ms,
                                "served_ms_b32": served_s * 1e3,
                                "served_img_s_b32": 32 / served_s})
        torch.backends.cudnn.allow_tf32 = True
        ms = time_ms(lambda: forward(fp32_fn, []))
        torch.backends.cudnn.allow_tf32 = False
        result["fp32_tf32_conv"] = {"forward_ms_b32": ms,
                                    "forward_img_s_b32": 32e3 / ms}
    finally:
        srv32.shutdown()
        srv16.shutdown()
    result["flash_attention_launches"] = fa.LAUNCHES
    log(json.dumps(result))


def _reset_launches():
    from mxnet_tpu_torch.ops import flash_attention as fa

    fa.LAUNCHES = fa.LAUNCHES_BWD_DKV = fa.LAUNCHES_BWD_DQ = 0


def _launches():
    from mxnet_tpu_torch.ops import flash_attention as fa

    return fa.LAUNCHES, fa.LAUNCHES_BWD_DKV, fa.LAUNCHES_BWD_DQ


def phase_attention_trained():
    """TrainStep over the attention block: bf16 at B 8, T 2048 (the
    main path: K1, K2, K3 once per step, the loss falls), then one fp32
    step at T 256 on the card against the same step on the host."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.examples.attention_layer import SelfAttention
    from mxnet_tpu_torch.gluon.utils import params_from_numpy
    from mxnet_tpu_torch.parallel import TrainStep, make_mesh

    units, steps = 1024, 8
    opt = {"learning_rate": 10.0, "momentum": 0.9}

    def build(ctx):
        mx.random.seed(SEED)
        net = SelfAttention(units, heads=16)
        net.initialize(mx.init.Xavier(), ctx=ctx)
        return net

    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((8, 2048, units),
                                             dtype=np.float32)).cuda()
    y = torch.from_numpy(rng.standard_normal((8, 2048, units),
                                             dtype=np.float32)).cuda()
    net = build(mx.gpu(0))
    step = TrainStep(net, gluon.loss.L2Loss(), "sgd", opt,
                     mesh=make_mesh({"dp": 1}, devices=[mx.gpu(0)]),
                     dtype="bfloat16")
    losses, per_step, times = [], [], []
    _reset_launches()  # the main path starts here
    for _ in range(steps):
        before = _launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(x, y))
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        per_step.append(tuple(a - b for a, b in zip(_launches(), before)))
    launches = _launches()  # read just after the path
    check(all(c == (1, 1, 1) for c in per_step),
          "K1/K2/K3 launches per step %s, not once each" % per_step)
    check(all(np.isfinite(losses)), "non-finite loss %s" % losses)
    check(losses[-1] < losses[0], "the loss did not fall: %s" % losses)

    # One fp32 step, card against host, from the same numpy weights.
    xs = rng.standard_normal((2, 256, units), dtype=np.float32)
    ys = rng.standard_normal((2, 256, units), dtype=np.float32)
    card_net = build(mx.gpu(0))
    w0 = {p.name: p.data().asnumpy()
          for p in card_net.collect_params().values()}
    with mx.cpu():
        host_net = SelfAttention(units, heads=16)
        host_net.initialize(ctx=mx.cpu())
        params_from_numpy(host_net, w0, prefix=card_net.prefix)
    results = {}
    for tag, n, ctx in (("card", card_net, mx.gpu(0)),
                        ("host", host_net, mx.cpu())):
        st = TrainStep(n, gluon.loss.L2Loss(), "sgd", opt,
                       mesh=make_mesh({"dp": 1}, devices=[ctx]))
        if tag == "card":
            _reset_launches()  # the fp32 path starts here
            loss = float(st(xs, ys))
            fp32_launches = _launches()  # read just after the path
        else:
            loss = float(st(xs, ys))
        results[tag] = (loss, _relative(st.state_to_host()[0], n.prefix))
    check(fp32_launches == (1, 1, 1), "the fp32 step launched K1/K2/K3 %s "
          "times, not once each" % (fp32_launches,))
    w0 = _relative(w0, card_net.prefix)
    loss_err = abs(results["card"][0] - results["host"][0]) / \
        abs(results["host"][0])
    step_errs = _step_state_errors(results["card"][1], results["host"][1],
                                   w0)
    log(json.dumps({
        "phase": "attention_trained", "shape": [8, 16, 2048, 64],
        "dtype": "bfloat16", "steps": steps, "losses": losses,
        "step_ms": times, "step_ms_median": float(np.median(times[2:])),
        "launches_per_step": per_step, "launches": launches,
        "fp32_step_card_vs_host": {
            "shape": [2, 16, 256, 64], "launches": fp32_launches,
            "loss_card": results["card"][0],
            "loss_host": results["host"][0], "loss_rel_err": loss_err,
            "update_rel_err": step_errs, "limits": [1e-5, 1e-3]}}))
    # fp32 on both sides, no kinks in the block: the card's loss within
    # 1e-5 relative, each weight's update within 1e-3 of its largest
    # entry (summation order only).
    check(loss_err < 1e-5, "fp32 attention loss card %r vs host %r"
          % (results["card"][0], results["host"][0]))
    check(max(step_errs.values()) < 1e-3,
          "fp32 attention update card vs host: %s" % step_errs)
    return launches, fp32_launches, float(np.median(times[2:]))


def phase_resnet_trained():
    """ResNet-50 v1 training: img/s at b32 (fp32 TF32 off, bf16) through
    the port's train_imagenet driver, then one step's parity over
    PARITY_SEEDS (see _resnet_parity)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples import train_imagenet

    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    _reset_launches()  # the main path starts here
    mx.random.seed(SEED)
    result = {"phase": "resnet50_v1_trained", "batch": 32, "windows": 2,
              "iters_per_window": 8}
    for tag, dtype in (("fp32", None), ("bf16", "bfloat16")):
        t0 = time.perf_counter()
        rate = train_imagenet.benchmark_rate("resnet50", 32, dtype,
                                             device=mx.gpu(0), iters=8,
                                             windows=2)
        result[tag] = {"img_s_b32": rate,
                       "ms_per_step": 32e3 / rate,
                       "phase_s": time.perf_counter() - t0}
    launches = _launches()  # read just after the path
    result["flash_attention_launches"] = launches
    check(launches == (0, 0, 0), "ResNet-50 training launched flash "
          "attention kernels %s" % (launches,))

    result["parity"] = [_resnet_parity(seed) for seed in PARITY_SEEDS]
    log(json.dumps(result))
    for reading in result["parity"]:
        check(reading["within"], "ResNet-50 step parity failed at seed %d: "
              "%s" % (reading["seed"], reading["failed"]))
    return result


# ResNet-50 step parity: seeds of the weights and data, batch, and limits.
# Forward quantities are smooth: the fp32 loss and running stats agree
# with the float64 step to fp32 summation order. The float64 step on the
# card and on the host is the same function up to float64 rounding, and
# its fp32 masters round the same update (momentum within 1e-5 of the
# tensor's largest entry, weights within two fp32 roundings plus 1e-5 of
# the largest update). An fp32 update is held tensor by tensor against
# the float64 one as closely as the host's own fp32 update is: a ReLU
# input within fp32 rounding of zero takes the other side in one run or
# the other and moves the gradients upstream of it. The fp32 limits are
# set from readings over these seeds on an H100 (PERF.md, Findings): per
# tensor the card's error was at most 3.4 times the host's, over the net
# (relative L2) at most 1.04 times.
PARITY_SEEDS = (0,)
PARITY_BATCH = 8
PARITY_LIMITS = {"f64_loss": 1e-9, "f64_momentum": 1e-5, "f64_aux": 1e-6,
                 "f64_weight_rtol": 2.0 ** -22, "f64_weight_step": 1e-5,
                 "fp32_loss": 1e-4, "fp32_aux": 1e-4,
                 "fp32_update_ratio": 4.0, "fp32_update_floor": 1e-3,
                 "fp32_update_l2_ratio": 1.5}


def _rel_max(got, want):
    """Per tensor, max |got - want| / max |want|."""
    return {n: float(np.abs(got[n] - w).max())
            / max(float(np.abs(w).max()), 1e-30) for n, w in want.items()}


def _rel_l2(got, want):
    """Relative L2 error over every tensor of a {name: array} state."""
    num = sum(float(np.sum((got[n] - w) ** 2)) for n, w in want.items())
    den = sum(float(np.sum(w ** 2)) for w in want.values())
    return (num / den) ** 0.5


def _trainer_parity_run(w0, prefix, xs, ys, opt):
    """One gluon.Trainer step (hybridized, fused) of ResNet-50 v1 on the
    card from the weights `w0`: the run dict _resnet_parity compares."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.gluon.utils import params_from_numpy

    t0 = time.perf_counter()
    net = vision.resnet50_v1(classes=1000)
    net.initialize(ctx=mx.gpu(0))
    params_from_numpy(net, w0, prefix=prefix)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(opt))
    loss = _record_and_backward(net, nd.array(xs, ctx=mx.gpu(0)),
                                nd.array(ys, ctx=mx.gpu(0)))
    trainer.step(xs.shape[0])
    params = list(net.collect_params().values())
    states = trainer._updater.states
    train = {p.name: p.data().asnumpy() for p in params
             if p.grad_req != "null"}
    mom = {p.name: states[i].asnumpy() for i, p in enumerate(params)
           if p.grad_req != "null"}
    aux = {p.name: p.data().asnumpy() for p in params
           if p.grad_req == "null"}
    check(trainer._applier.num_compiles >= 1, "the parity Trainer step did "
          "not take the fused path")
    return {"loss": float(loss.asnumpy().mean()),
            "w": _relative(train, net.prefix),
            "mom": _relative(mom, net.prefix),
            "aux": _relative(aux, net.prefix),
            "seconds": time.perf_counter() - t0}


def _resnet_parity(seed):
    """One SGD-momentum-wd step of ResNet-50 v1 at PARITY_BATCH from one
    set of weights: fp32 and float64 on the card, fp32 on the host, and
    (first seed) float64 on the host; held to PARITY_LIMITS. The same
    step through gluon.Trainer on the card (``card_trainer``) is held to
    the fp32 terms, and compared with the TrainStep step bit for bit
    (printed, not held: cuDNN may pick nondeterministic algorithms)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.gluon.utils import params_from_numpy
    from mxnet_tpu_torch.parallel import TrainStep, make_mesh

    lim = PARITY_LIMITS
    rng = np.random.default_rng(seed)
    xs = rng.random((PARITY_BATCH, 3, 224, 224), dtype=np.float32)
    ys = rng.integers(0, 1000, PARITY_BATCH).astype(np.float32)
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}

    def train_step(net, ctx, dtype):
        return TrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                         opt, mesh=make_mesh({"dp": 1}, devices=[ctx]),
                         dtype=dtype)

    mx.random.seed(seed)
    card_net = vision.resnet50_v1(classes=1000)
    card_net.initialize(mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
                        ctx=mx.gpu(0))
    runs = {"card_fp32": train_step(card_net, mx.gpu(0), None)}
    runs["card_fp32"]._materialize(torch.from_numpy(xs[:1]))
    w0 = {p.name: p.data().asnumpy()
          for p in card_net.collect_params().values()}
    runs["card_f64"] = train_step(card_net, mx.gpu(0), "float64")
    hosts = [("host_fp32", None)]
    if seed == PARITY_SEEDS[0]:
        hosts.append(("host_f64", "float64"))
    for tag, dtype in hosts:
        with mx.cpu():
            net = vision.resnet50_v1(classes=1000)
            net.initialize(ctx=mx.cpu())
            params_from_numpy(net, w0, prefix=card_net.prefix)
        runs[tag] = train_step(net, mx.cpu(), dtype)
    out = {}
    for tag, st in runs.items():
        t0 = time.perf_counter()
        loss = float(st(xs, ys))
        params, states, aux = st.state_to_host()
        pre = st.net.prefix
        out[tag] = {"loss": loss, "w": _relative(params, pre),
                    "mom": _relative({n: s[0] for n, s in states.items()},
                                     pre),
                    "aux": _relative(aux, pre),
                    "seconds": time.perf_counter() - t0}
        del st
    runs.clear()
    out["card_trainer"] = _trainer_parity_run(w0, card_net.prefix, xs, ys,
                                              opt)
    w0 = _relative(w0, card_net.prefix)
    ref = out["card_f64"]
    failed = []

    def hold(name, value, limit):
        if not value <= limit:
            failed.append("%s %g > %g" % (name, value, limit))

    reading = {"seed": seed, "batch": PARITY_BATCH,
               "step_seconds": {t: o["seconds"] for t, o in out.items()},
               "loss": {t: o["loss"] for t, o in out.items()}}
    if "host_f64" in out:
        host = out["host_f64"]
        mom = _rel_max(ref["mom"], host["mom"])
        aux = _rel_max(ref["aux"], host["aux"])
        weight_excess = max(
            float((np.abs(ref["w"][n] - w) - lim["f64_weight_rtol"]
                   * np.abs(w)).max())
            / max(float(np.abs(w - w0[n]).max()), 1e-30)
            for n, w in host["w"].items())
        loss = abs(ref["loss"] - host["loss"]) / abs(host["loss"])
        reading["card_f64_vs_host_f64"] = {
            "loss_rel": loss, "momentum_rel_max": max(mom.values()),
            "aux_rel_max": max(aux.values()),
            "weight_excess_over_step": weight_excess}
        hold("f64 loss", loss, lim["f64_loss"])
        hold("f64 momentum", max(mom.values()), lim["f64_momentum"])
        hold("f64 running stats", max(aux.values()), lim["f64_aux"])
        hold("f64 weights", weight_excess, lim["f64_weight_step"])
    errs = {}
    for tag in ("card_fp32", "host_fp32", "card_trainer"):
        o = out[tag]
        errs[tag] = _rel_max(o["mom"], ref["mom"])
        loss = abs(o["loss"] - ref["loss"]) / abs(ref["loss"])
        aux = max(_rel_max(o["aux"], ref["aux"]).values())
        e = sorted(errs[tag].values())
        reading[tag + "_vs_card_f64"] = {
            "loss_rel": loss, "aux_rel_max": aux,
            "momentum_rel_l2": _rel_l2(o["mom"], ref["mom"]),
            "momentum_rel_median": e[len(e) // 2],
            "momentum_rel_max": e[-1]}
        hold(tag + " loss", loss, lim["fp32_loss"])
        hold(tag + " running stats", aux, lim["fp32_aux"])
    excess = {n: errs["card_fp32"][n] - lim["fp32_update_ratio"]
              * errs["host_fp32"][n] for n in errs["card_fp32"]}
    worst = sorted(excess, key=lambda n: -excess[n])[:5]
    reading["fp32_update_worst"] = [
        [n, errs["card_fp32"][n], errs["host_fp32"][n]] for n in worst]
    ratios = sorted(errs["card_fp32"][n] / max(errs["host_fp32"][n], 1e-30)
                    for n in errs["card_fp32"])
    reading["fp32_update_ratio_quantiles"] = [
        ratios[int(q * (len(ratios) - 1))] for q in (0.5, 0.9, 1.0)]
    hold("fp32 update of %s over %g x host's" % (worst[0],
                                                 lim["fp32_update_ratio"]),
         excess[worst[0]], lim["fp32_update_floor"])
    hold("fp32 update over the net against host's",
         reading["card_fp32_vs_card_f64"]["momentum_rel_l2"]
         / reading["host_fp32_vs_card_f64"]["momentum_rel_l2"],
         lim["fp32_update_l2_ratio"])
    # The Trainer's step, held to the same fp32 terms.
    t_excess = {n: errs["card_trainer"][n] - lim["fp32_update_ratio"]
                * errs["host_fp32"][n] for n in errs["card_trainer"]}
    t_worst = max(t_excess, key=lambda n: t_excess[n])
    hold("Trainer fp32 update of %s over %g x host's"
         % (t_worst, lim["fp32_update_ratio"]), t_excess[t_worst],
         lim["fp32_update_floor"])
    hold("Trainer fp32 update over the net against host's",
         reading["card_trainer_vs_card_f64"]["momentum_rel_l2"]
         / reading["host_fp32_vs_card_f64"]["momentum_rel_l2"],
         lim["fp32_update_l2_ratio"])
    tr, ts = out["card_trainer"], out["card_fp32"]
    reading["trainer_equals_train_step_bitwise"] = {
        "weights": all(np.array_equal(tr["w"][n], ts["w"][n])
                       for n in ts["w"]),
        "momentum": all(np.array_equal(tr["mom"][n], ts["mom"][n])
                        for n in ts["mom"]),
        "loss": tr["loss"] == ts["loss"]}
    reading["limits"] = lim
    reading["failed"] = failed
    reading["within"] = not failed
    log(json.dumps({"check": "ResNet-50 step parity", **reading}))
    return reading



# -- slice 3: K4, rtc.CudaModule over NVRTC ----------------------------------

def _bytes_bound(card, nbytes):
    """Least time (ms) to move `nbytes` once at the card's memory rate;
    the elementwise rtc kernels do too little arithmetic for it to
    bind."""
    return nbytes / PEAKS["H200" if "H200" in card else "H100"]["bytes"] \
        * 1e3


def resnet50_bn_relu_shapes(batch=32):
    """{(N, C, H, W): fragments} of the BatchNorm -> relu pairs of
    ResNet-50 v1 at 224x224 (mxnet_tpu/gluon/model_zoo/vision/resnet.py:
    58-75, the stride on the 3x3): the stem, then two per bottleneck."""
    shapes = {(batch, 64, 112, 112): 1}
    size = 56
    for stage, (blocks, ch) in enumerate(((3, 256), (4, 512), (6, 1024),
                                          (3, 2048))):
        for b in range(blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            mid = ch // 4
            first = (batch, mid, size, size)
            size //= stride
            second = (batch, mid, size, size)
            for s in (first, second):
                shapes[s] = shapes.get(s, 0) + 1
    return shapes


def phase_rtc_direct():
    """The direct rtc entry points as a user calls them: scale_add
    through the CudaModule/CudaKernel API on the JAX fixture (1, 8) and
    at 4096x4096, and relu as the kernel of a partitioned dense-relu
    MLP (b32, 1024 -> 4096 -> 1000). Counts are reset just before and
    read just after."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _nvrtc, rtc, subgraph
    from mxnet_tpu_torch.examples import rtc_kernels

    class DenseReLU(subgraph.SubgraphProperty):
        """The fixture of the JAX package's test_partition_pallas_backend:
        relu over FullyConnected, the matmul in torch, the relu the rtc
        kernel."""

        def select(self, node):
            return node._op == "Activation"

        def select_input(self, node, inp):
            return inp._op == "FullyConnected"

        def create_fn(self, sub_sym, arg_names):
            return lambda x, w, b: rtc_kernels.relu(
                torch.matmul(x, w.t()) + b)

    stats0 = dict(_nvrtc.STATS)
    t0 = time.perf_counter()
    rtc_kernels.module()
    compile_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    a = torch.arange(8, dtype=torch.float32, device="cuda").reshape(1, 8)
    b = torch.ones(1, 8, device="cuda")
    x = torch.randn(4096, 4096, generator=gen, device="cuda")
    y = torch.randn(4096, 4096, generator=gen, device="cuda")

    data = mx.sym.var("data")
    mlp = mx.sym.FullyConnected(data, num_hidden=4096, name="fc")
    mlp = mx.sym.Activation(mlp, act_type="relu", name="act")
    mlp = mx.sym.FullyConnected(mlp, num_hidden=1000, name="out")
    part = subgraph.partition(mlp, DenseReLU())
    rng = np.random.default_rng(SEED)
    shapes, _, _ = mlp.infer_shape(data=(32, 1024))
    args = {n: mx.nd.array(rng.standard_normal(s, dtype=np.float32)
                           * (0.03 if n != "data" else 1.0), ctx=mx.gpu(0))
            for n, s in zip(mlp.list_arguments(), shapes)}

    rtc_kernels.LAUNCHES.update(scale_add=0, relu=0)
    rtc.LAUNCHES = 0  # the main path starts here
    got_fixture = rtc_kernels.scale_add(a, b)
    got_big = rtc_kernels.scale_add(x, y)
    got_mlp = part.bind(mx.gpu(0), args, grad_req="null").forward()[0]
    torch.cuda.synchronize()
    launches = dict(rtc_kernels.LAUNCHES, rtc=rtc.LAUNCHES)  # just after
    check(launches == {"scale_add": 2, "relu": 1, "rtc": 3},
          "rtc direct path launches %s" % launches)
    want_mlp = mlp.bind(mx.gpu(0), args, grad_req="null").forward()[0]
    check(bool(torch.equal(got_fixture,
                           rtc_kernels.scale_add_reference(a, b))),
          "scale_add disagrees with its plain version at (1, 8)")
    check(bool(torch.equal(got_big, rtc_kernels.scale_add_reference(x, y))),
          "scale_add disagrees with its plain version at 4096x4096")
    # The fragment adds the bias after the product, FullyConnected inside
    # cuBLAS's epilogue: one rounding apart.
    mlp_err = _hold("the rtc relu MLP against the unpartitioned one",
                    got_mlp.data_, want_mlp.data_, 1e-5, 1e-6)
    pre = torch.matmul(args["data"].data_, args["fc_weight"].data_.t()) \
        + args["fc_bias"].data_
    check(bool(torch.equal(rtc_kernels.relu(pre),
                           rtc_kernels.relu_reference(pre))),
          "relu disagrees with its plain version")
    odd = _scale_add_at_an_odd_offset(gen)
    log(json.dumps({"phase": "rtc_direct", "launches": launches,
                    "scale_add_odd_offset": odd,
                    "mlp_max_abs_err_vs_unpartitioned": mlp_err,
                    "nvrtc_compile_s": compile_s,
                    "nvrtc_stats_delta": {k: _nvrtc.STATS[k] - stats0[k]
                                          for k in stats0},
                    "compile_log": rtc_kernels.module().compile_log}))
    return launches, (x, y, pre)


def _scale_add_at_an_odd_offset(gen, n=4096 * 33 + 3):
    """scale_add on contiguous views one element past a 16-byte boundary,
    at an odd n, through the public API: CudaModule/CudaKernel.launch on
    NDArrays with every pointer at that offset (a scalar head, float4
    vectors, a scalar tail), and the wrapper, whose aligned output makes
    the pointers differ mod 16 (the scalar path). Exact against the
    plain version."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples import rtc_kernels
    from mxnet_tpu_torch.ndarray.ndarray import NDArray

    x, y, out = (torch.randn(n + 1, generator=gen, device="cuda")[1:]
                 for _ in range(3))
    want = rtc_kernels.scale_add_reference(x, y)
    with open(rtc_kernels.SOURCE) as f:
        kern = mx.rtc.CudaModule(f.read()).get_kernel(
            "scale_add", "const float *x, const float *y, float *out, "
            "int64_t n")
    plan = rtc_kernels.launch_plan(n, (x.data_ptr() % 16) // 4)
    kern.launch([NDArray(x), NDArray(y), NDArray(out), n], mx.gpu(0),
                (plan[3],), (256,))
    check(bool(torch.equal(out, want)), "scale_add through CudaKernel.launch"
          " disagrees with its plain version at offset 1, n %d" % n)
    check(bool(torch.equal(rtc_kernels.scale_add(x, y), want)),
          "scale_add disagrees with its plain version at offset 1, n %d" % n)
    return {"n": n, "offset_bytes": x.data_ptr() % 16,
            "plan": list(plan), "exact": True}


def _hold(name, got, want, rtol, atol_rel):
    atol = atol_rel * float(want.abs().max())
    err = float((got - want).abs().max())
    check(max_violation(got, want, rtol, atol) <= 0,
          "%s disagrees with its plain version: %g (rtol %g, atol %g)"
          % (name, err, rtol, atol))
    return err


def _elementwise_times(card, kernel, plain, library, nbytes):
    """An elementwise rtc kernel's times (ms) beside its plain version and
    the library call: device time (time_queued) and back-to-back calls
    (ms_host_window), with its bytes bound and the kernel's share."""
    row = {"ms": time_queued(kernel), "ms_host_window": time_each(kernel),
           "plain_ms": time_queued(plain),
           "bound_ms": _bytes_bound(card, nbytes),
           "library_ms": time_queued(library),
           "library_ms_host_window": time_each(library)}
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["library_bound_share"] = row["bound_ms"] / row["library_ms"]
    return row


def phase_rtc_kernels(card, tensors):
    """Each rtc kernel against its plain version and timed beside it,
    its bound and the library call: scale_add and relu exactly at the
    direct path's shapes; fused BatchNorm(inference)+ReLU at every
    distinct ResNet-50 v1 b32 shape within rtol 1e-5 + 1e-6 max|want|.
    Also the host cost of one CudaKernel.launch."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.context import Context
    from mxnet_tpu_torch.examples import fused_bn_relu as fb
    from mxnet_tpu_torch.examples import rtc_kernels
    from mxnet_tpu_torch.ndarray.ndarray import NDArray

    x, y, pre = tensors
    n0, r0, k0 = fb.LAUNCHES, dict(rtc_kernels.LAUNCHES), rtc.LAUNCHES
    entries = {}
    err = float((rtc_kernels.scale_add(x, y)
                 - rtc_kernels.scale_add_reference(x, y)).abs().max())
    check(err == 0, "scale_add not exact: %g" % err)
    entries["scale_add"] = {
        "name": "rtc_scale_add", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/rtc/elementwise.cu",
        "replaces": "mxnet_tpu/rtc.py:87", "max_abs_err": err,
        **_elementwise_times(card, lambda: rtc_kernels.scale_add(x, y),
                             lambda: rtc_kernels.scale_add_reference(x, y),
                             lambda: torch.add(y, x, alpha=2.0),
                             3 * 4 * x.numel()),
        "bound_by": "bytes",
        "library_call": "torch.add(y, x, alpha=2)",
        "shape": list(x.shape), "dtype": "float32"}
    err = float((rtc_kernels.relu(pre) - torch.relu(pre)).abs().max())
    check(err == 0, "relu not exact: %g" % err)
    # relu also where bytes, not the launch, set the time: over x.
    large_err = float((rtc_kernels.relu(x) - torch.relu(x)).abs().max())
    check(large_err == 0, "relu not exact at 4096x4096: %g" % large_err)
    entries["relu"] = {
        "name": "rtc_relu", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/rtc/elementwise.cu",
        "replaces": "mxnet_tpu/rtc.py:87", "max_abs_err": err,
        **_elementwise_times(card, lambda: rtc_kernels.relu(pre),
                             lambda: rtc_kernels.relu_reference(pre),
                             lambda: F.relu(pre), 2 * 4 * pre.numel()),
        "bound_by": "bytes",
        "library_call": "torch.nn.functional.relu",
        "shape": list(pre.shape), "dtype": "float32",
        "at_4096x4096": {
            "shape": list(x.shape), "max_abs_err": large_err,
            **_elementwise_times(card, lambda: rtc_kernels.relu(x),
                                 lambda: rtc_kernels.relu_reference(x),
                                 lambda: F.relu(x), 2 * 4 * x.numel())}}

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    per_shape, bn_err, both_err = [], 0.0, None
    totals = {"ms": 0.0, "ms_host_window": 0.0, "plain_ms": 0.0,
              "bound_ms": 0.0, "library_ms": 0.0}
    for shape, count in resnet50_bn_relu_shapes(32).items():
        c = shape[1]
        xb = torch.randn(shape, generator=gen, device="cuda")
        g, be, m = (torch.rand(c, generator=gen, device="cuda") - 0.5
                    for _ in range(3))
        g, v = g + 1.0, torch.rand(c, generator=gen, device="cuda") + 0.5
        args = (xb, g, be, m, v, 1e-5, False, 1)
        got = fb.bn_relu(*args)
        want = fb.bn_relu_reference(*args)
        bn_err = max(bn_err, _hold("bn_relu %s" % (shape,), got, want, 1e-5,
                                   1e-6))
        row = {"shape": list(shape), "fragments": count,
               "ms": time_queued(lambda: fb.bn_relu(*args)),
               "ms_host_window": time_each(lambda: fb.bn_relu(*args)),
               "plain_ms": time_queued(lambda: fb.bn_relu_reference(*args)),
               "bound_ms": _bytes_bound(card, 2 * 4 * xb.numel()),
               "library_ms": time_queued(lambda: F.relu(F.batch_norm(
                   xb, m, v, g, be, training=False, eps=1e-5)))}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        per_shape.append(row)
        for k in totals:
            totals[k] += row[k] * count
        if shape == (32, 256, 28, 28):
            # The two-output variant, for a pair whose BatchNorm output
            # is read elsewhere too (not on ResNet-50's path): held, not
            # timed.
            both = zip(("z", "y"), fb.bn_and_relu(*args),
                       fb.bn_and_relu_reference(*args))
            both_err = max(_hold("bn_and_relu %s %s" % (k, shape), got_k,
                                 want_k, 1e-5, 1e-6)
                           for k, got_k, want_k in both)
            del both
        del xb, got, want
    stem = per_shape[0]
    entries["bn_relu"] = {
        "name": "rtc_bn_relu", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/rtc/fused_bn_relu.cu",
        "replaces": "mxnet_tpu/rtc.py:87", "max_abs_err": bn_err,
        "ms": stem["ms"], "plain_ms": stem["plain_ms"],
        "bound_ms": stem["bound_ms"], "bound_by": "bytes",
        "library_ms": stem["library_ms"],
        "library_call": "F.batch_norm(training=False) then F.relu",
        "shape": stem["shape"], "dtype": "float32",
        "per_shape": per_shape, "per_b32_forward": totals}

    # K4 itself: the runtime kernel surface, measured on its main path:
    # the 33 fused launches of one ResNet-50 b32 forward, summed; and the
    # host cost of one launch through CudaKernel.launch.
    kern = fb._get_kernel()
    tiny = [NDArray(torch.zeros(1, device="cuda")) for _ in range(6)]
    ctx = Context.of(tiny[0].data_.device)
    wrapper_x = torch.zeros(1, 1, 1, 1, device="cuda")
    one = torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        kern.launch(tiny + [1, 1, 1, 1e-5, 0], ctx, (1,), (32,))
    launch_us = (time.perf_counter() - t0) / 200 * 1e6
    t0 = time.perf_counter()
    for _ in range(200):
        fb.bn_relu(wrapper_x, one, one, one, one, 1e-5, False, 1)
    wrapper_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    entries["k4"] = {
        "name": "rtc.CudaModule (K4)", "route": "cuda",
        "source": "mxnet_tpu_torch/rtc.py",
        "replaces": "mxnet_tpu/rtc.py:87",
        "max_abs_err": max(bn_err, entries["scale_add"]["max_abs_err"],
                           entries["relu"]["max_abs_err"]),
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"], "bound_by": "bytes",
        "library_ms": totals["library_ms"],
        "ms_host_window": totals["ms_host_window"],
        "what": "NVRTC-compiled kernels launched through CudaKernel.launch;"
                " times: the 33 BN+ReLU launches of one ResNet-50 v1 b32 "
                "forward, summed (device time, the card kept ahead of the "
                "host; ms_host_window: back-to-back calls, host-bound at "
                "the small shapes)",
        "host_us_per_launch": launch_us,
        "host_us_per_bn_relu_call": wrapper_us}
    # the comparisons above are not a main path: restore the counts
    fb.LAUNCHES, rtc.LAUNCHES = n0, k0
    rtc_kernels.LAUNCHES.update(r0)
    check(both_err is not None, "bn_and_relu was not held")
    log(json.dumps({"phase": "rtc_kernels", "bn_relu_per_shape": per_shape,
                    "bn_relu_per_b32_forward": totals,
                    "bn_and_relu_max_abs_err": both_err,
                    "host_us_per_launch": launch_us,
                    "host_us_per_bn_relu_call": wrapper_us}))
    return entries


def _randomize_bn(net, seed):
    """Non-trivial BatchNorm parameters and statistics, from numpy, so
    the fused kernel's arithmetic is exercised."""
    rng = np.random.default_rng(seed)
    for name, p in net.collect_params().items():
        if name.endswith(("running_var", "gamma")):
            p.set_data(rng.uniform(0.8, 1.2, p.shape).astype(np.float32))
        elif name.endswith(("running_mean", "beta")):
            p.set_data(rng.uniform(-0.1, 0.1, p.shape).astype(np.float32))


def phase_checkpoint_served():
    """ResNet-50 v1 exported and served from its checkpoint through
    InferenceServer.from_checkpoint, fp32 (TF32 off), buckets 1/8/32:
    once plain and once with MXNET_SUBGRAPH_BACKEND=fused_bn_relu. The
    fused kernel launches exactly 33 times per forward (warmup included)
    under the partition and never without it; both servers and the
    hybridized gluon net agree within 1e-5 of the largest logit; img/s
    at b32 on a batch on the card and through predict()."""
    import os
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _nvrtc, autograd, nd, rtc, serving
    from mxnet_tpu_torch.examples import fused_bn_relu as fb
    from mxnet_tpu_torch.gluon.model_zoo import vision

    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    item, buckets = (3, 224, 224), (1, 8, 32)
    compiles0 = _nvrtc.STATS["compiles"]
    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=mx.gpu(0))
    net.hybridize()
    rng = np.random.default_rng(SEED + 5)
    probe = rng.random((5,) + item, dtype=np.float32)
    with torch.no_grad(), autograd.pause():
        net(nd.array(probe[:1], ctx=mx.gpu(0)))
    _randomize_bn(net, SEED + 6)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "mxnet_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt-", dir=build)
    result = {"phase": "resnet50_v1_checkpoint_served", "buckets": buckets}
    servers = {}
    try:
        t0 = time.perf_counter()
        prefix = os.path.join(tmp, "resnet50_v1")
        net.export(prefix)
        result["export_s"] = time.perf_counter() - t0
        with torch.no_grad(), autograd.pause():
            want = net(nd.array(probe, ctx=mx.gpu(0))).data_
        rows = [1, 5, 32]
        reqs = [probe[:1], probe, rng.random((32,) + item, dtype=np.float32)]
        for tag in ("plain", "partitioned"):
            if tag == "partitioned":
                os.environ["MXNET_SUBGRAPH_BACKEND"] = fb.BACKEND
            fb.LAUNCHES = rtc.LAUNCHES = 0  # the main path starts here
            t0 = time.perf_counter()
            try:
                srv = serving.InferenceServer.from_checkpoint(
                    prefix, 0, item_shape=item, buckets=buckets,
                    max_delay_ms=5, ctx=mx.gpu(0))
            finally:
                os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
            servers[tag] = srv
            warm_s = time.perf_counter() - t0
            with ThreadPoolExecutor(len(reqs)) as pool:
                futs = list(pool.map(srv.submit, reqs))
            outs = [f.result(timeout=300) for f in futs]
            launches = (fb.LAUNCHES, rtc.LAUNCHES)  # read just after
            exs = srv._model._executors
            forwards = sum(ex.num_forwards for ex in exs.values())
            frags = {b[0]: sum(1 for n in ex._symbol._topo()
                               if n._op == "_subgraph")
                     for b, ex in exs.items()}
            check(srv.compile_count == len(buckets),
                  "%s: compile_count %d" % (tag, srv.compile_count))
            for r, o in zip(rows, outs):
                check(o.shape == (r, 1000), "served shape %s" % (o.shape,))
                check(bool(torch.isfinite(o.data_).all()),
                      "non-finite %s output" % tag)
            per_fwd = 33 if tag == "partitioned" else 0
            check(all(f == per_fwd for f in frags.values()),
                  "%s: fragments per bucket %s" % (tag, frags))
            check(launches == (per_fwd * forwards, per_fwd * forwards),
                  "%s: bn_relu/rtc launches %s for %d forwards"
                  % (tag, launches, forwards))
            result[tag] = {"warmup_s": warm_s, "forwards": forwards,
                           "batches": srv.metrics.total_batches,
                           "fragments_per_bucket": frags,
                           "bn_relu_launches": launches[0],
                           "rtc_launches": launches[1],
                           "probe": outs[1].data_}
        scale = float(want.abs().max())
        errs = {}
        for tag in servers:
            got = result[tag].pop("probe")
            errs[tag + "_vs_gluon"] = float((got - want).abs().max())
        errs["partitioned_vs_plain"] = float(
            (servers["partitioned"].predict(probe).data_
             - servers["plain"].predict(probe).data_).abs().max())
        result["agreement"] = {"max_abs_logit": scale, "limit": 1e-5 * scale,
                               **errs}
        for k, e in errs.items():
            check(e <= 1e-5 * scale, "%s: %g > 1e-5 x %g" % (k, e, scale))

        batch = nd.array(rng.random((32,) + item, dtype=np.float32),
                         ctx=mx.gpu(0))
        host32 = rng.random((32,) + item, dtype=np.float32)

        def gluon_forward():
            with torch.no_grad(), autograd.pause():
                net(batch).wait_to_read()

        result["gluon_hybridized"] = {"forward_ms_b32":
                                      time_ms(gluon_forward)}
        for tag, srv in servers.items():
            n0 = fb.LAUNCHES
            ms = time_ms(lambda: srv._model(batch).wait_to_read())
            t0 = time.perf_counter()
            for _ in range(ITERS):
                srv.predict(host32).wait_to_read()
            served = (time.perf_counter() - t0) / ITERS
            result[tag].update({"forward_ms_b32": ms,
                                "forward_img_s_b32": 32e3 / ms,
                                "served_ms_b32": served * 1e3,
                                "served_img_s_b32": 32 / served,
                                "stats": srv.stats()})
            fb.LAUNCHES = n0  # timing runs are not the main path
    finally:
        for srv in servers.values():
            srv.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    # 3 buckets x 33 fragments share one compiled program
    result["nvrtc_stats"] = dict(_nvrtc.STATS)
    compiled = _nvrtc.STATS["compiles"] - compiles0
    check(compiled <= 1, "NVRTC compiled %d programs in the checkpoint "
          "phase, not at most one" % compiled)
    log(json.dumps(result))
    return result


# -- slice 7: the imperative trainer (gluon.Trainer) --------------------------

TRAINER_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
RESNET50_TRAINABLE = 161


def _resnet50(seed=SEED, dtype=None):
    """ResNet-50 v1 at full width on the card, initialized as the
    TrainStep phases initialize it, shapes inferred, hybridized."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision

    mx.random.seed(seed)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=mx.gpu(0))
    with autograd.pause():
        net(nd.zeros((1, 3, 224, 224), ctx=mx.gpu(0)))
    if dtype is not None:
        net.cast(dtype)
    net.hybridize()
    return net


def _copy_weights(src, dst):
    for p, q in zip(src.collect_params().values(),
                    dst.collect_params().values()):
        q.data()._data.detach().copy_(p.data()._data.detach())


def _trainable(net):
    return [p for p in net.collect_params().values() if p.grad_req != "null"]


def _record_and_backward(net, x, y, cast_out=False, loss_fn=None):
    from mxnet_tpu_torch import autograd, gluon

    loss_fn = loss_fn or gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        out = net(x)
        if cast_out:
            out = out.astype("float32")
        loss = loss_fn(out, y)
    loss.backward()
    return loss


def _state_tensors(trainer):
    """{index: [state tensors]} of a trainer's updater, nesting
    flattened ((inner, master) under multi_precision)."""
    def flat(s):
        if s is None:
            return []
        if isinstance(s, (list, tuple)):
            return [t for x in s for t in flat(x)]
        return [s._data]

    return {i: flat(s) for i, s in trainer._updater.states.items()}


def _trainer_img_s(net, trainer, x, y, cast_out, warmup=3, windows=3,
                   iters=10):
    """benchmark_rate's protocol over the Trainer loop: warmup steps,
    then the median img/s of `windows` windows of `iters` steps, each
    closed by a host readback of the loss."""
    loss = None
    for _ in range(warmup):
        loss = _record_and_backward(net, x, y, cast_out)
        trainer.step(x.shape[0])
    float(loss.asnumpy().mean())
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            loss = _record_and_backward(net, x, y, cast_out)
            trainer.step(x.shape[0])
        float(loss.asnumpy().mean())
        rates.append(x.shape[0] * iters / (time.perf_counter() - t0))
    return sorted(rates)[len(rates) // 2], float(loss.asnumpy().mean())


def _optimizer_profile(trainer, batch, reps=5):
    """Per trainer.step on the gradients in place: CUDA launches and
    device ms (torch.profiler), and host ms (the card synchronised at
    the end of the window)."""
    trainer.step(batch)       # plans and states exist
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        trainer.step(batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(reps):
            trainer.step(batch)
        torch.cuda.synchronize()
    count, device_us = 0, 0.0
    for evt in prof.key_averages():
        if str(evt.device_type).endswith("CUDA"):
            count += evt.count
            device_us += evt.self_device_time_total
    return {"launches_per_step": count / reps,
            "device_ms_per_step": device_us / 1e3 / reps,
            "wall_ms_per_step": wall}


def _fused_equals_loop(dtype, x, y, steps=2):
    """From one state and on the same gradients, `steps` fused steps and
    `steps` loop steps: every weight and optimizer-state tensor equal bit
    for bit. Returns the number of trainable tensors held."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon

    opt = dict(TRAINER_OPT, multi_precision=dtype is not None)
    nets = [_resnet50(dtype=dtype) for _ in range(2)]
    _copy_weights(nets[0], nets[1])
    trainers = [gluon.Trainer(n.collect_params(), "sgd", dict(opt), fused=f)
                for n, f in zip(nets, (True, False))]
    train = [_trainable(n) for n in nets]
    check(len(train[0]) == RESNET50_TRAINABLE, "ResNet-50 v1 has %d "
          "trainable tensors, not %d" % (len(train[0]), RESNET50_TRAINABLE))
    for _ in range(steps):
        _record_and_backward(nets[0], x, y, dtype is not None)
        for p, q in zip(*train):
            q.grad()._data.copy_(p.grad()._data)
        for t in trainers:
            t.step(x.shape[0])
    bad = [p.name for p, q in zip(*train)
           if not torch.equal(p.data()._data, q.data()._data)]
    sa, sb = (_state_tensors(t) for t in trainers)
    bad += ["state %d" % i for i in sa
            if len(sa[i]) != len(sb[i]) or
            not all(torch.equal(u, v) for u, v in zip(sa[i], sb[i]))]
    check(not bad, "fused != loop (%s) at %s" % (dtype or "fp32", bad[:5]))
    check(trainers[0]._applier.num_compiles >= 1
          and trainers[1]._applier.num_compiles == 0,
          "the fused trainer did not fuse, or the loop trainer did")
    masters = [s for i, s in trainers[0]._updater.states.items()]
    if dtype is not None:
        check(all(isinstance(s, tuple) and len(s) == 2
                  and s[1]._data.dtype == torch.float32 for s in masters),
              "bf16 states are not (inner, fp32 master)")
    del nets, trainers
    return len(train[0])


def _resume_equals_uninterrupted(x, y, tmpdir):
    """4 uninterrupted fused steps against 2 steps, save_states,
    load_states into a fresh Trainer, 2 more steps, on the same recorded
    gradients: weights and states equal bit for bit."""
    import os

    from mxnet_tpu_torch import gluon

    nets = [_resnet50() for _ in range(2)]
    _copy_weights(nets[0], nets[1])
    train = [_trainable(n) for n in nets]
    ref = gluon.Trainer(nets[0].collect_params(), "sgd", dict(TRAINER_OPT))
    grads = []
    for _ in range(4):
        _record_and_backward(nets[0], x, y)
        grads.append([p.grad()._data.clone() for p in train[0]])
        ref.step(x.shape[0])
    path = os.path.join(tmpdir, "trainer.states")
    tr = gluon.Trainer(nets[1].collect_params(), "sgd", dict(TRAINER_OPT))
    for k, gs in enumerate(grads):
        if k == 2:
            tr.save_states(path)
            tr = gluon.Trainer(nets[1].collect_params(), "sgd",
                               dict(TRAINER_OPT))
            tr.load_states(path)
        for q, g in zip(train[1], gs):
            q.grad()._data.copy_(g)
        tr.step(x.shape[0])
    bad = [p.name for p, q in zip(*train)
           if not torch.equal(p.data()._data, q.data()._data)]
    sa, sb = _state_tensors(ref), _state_tensors(tr)
    bad += ["state %d" % i for i in sa
            if not all(torch.equal(u, v) for u, v in zip(sa[i], sb[i]))]
    check(not bad, "resumed Trainer != uninterrupted at %s" % bad[:5])
    return os.path.getsize(path)


def _update_bytes(net, dtype):
    """Bytes one SGD-momentum update must move: read weight, gradient
    and momentum, write weight and momentum; with fp32 masters also
    read and write the master, the momentum fp32."""
    n = sum(p.data().size for p in _trainable(net))
    if dtype is None:
        return 5 * 4 * n
    return (2 + 2 + 4 + 4) * n + (2 + 4 + 4) * n


def phase_resnet_trainer(card_line):
    """ResNet-50 v1 through gluon.Trainer (see the module docstring,
    phase 11)."""
    import os
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd

    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    rng = np.random.default_rng(SEED)
    xs = rng.random((32, 3, 224, 224), dtype=np.float32)
    ys = rng.integers(0, 1000, 32).astype(np.float32)
    y = nd.array(ys, ctx=mx.gpu(0))
    result = {"phase": "resnet50_v1_trainer", "card": card_line,
              "batch": 32, "optimizer": ["sgd", TRAINER_OPT],
              "windows": 2, "iters_per_window": 10}
    _reset_launches()  # the main path starts here
    card = torch.cuda.get_device_name(0)
    for tag, dtype in (("fp32", None), ("bf16_mp", "bfloat16")):
        x = nd.array(xs, ctx=mx.gpu(0), dtype=dtype or "float32")
        net = _resnet50(dtype=dtype)
        opt = dict(TRAINER_OPT, multi_precision=dtype is not None)
        trainer = gluon.Trainer(net.collect_params(), "sgd", opt)
        t0 = time.perf_counter()
        rate, loss = _trainer_img_s(net, trainer, x, y, dtype is not None,
                                    windows=2)
        entry = {"img_s_b32": rate, "ms_per_step": 32e3 / rate,
                 "loss": loss, "phase_s": time.perf_counter() - t0,
                 "fused_plans": trainer._applier.num_compiles}
        check(np.isfinite(loss), "non-finite Trainer loss %r" % loss)
        check(trainer._applier.num_compiles >= 1, "the Trainer did not "
              "take the fused path")
        # The optimizer alone, on the gradients of the last step.
        fused = _optimizer_profile(trainer, 32)
        loop = gluon.Trainer(net.collect_params(), "sgd", opt, fused=False)
        _record_and_backward(net, x, y, dtype is not None)
        per_param = _optimizer_profile(loop, 32)
        for key in ("launches_per_step", "device_ms_per_step",
                    "wall_ms_per_step"):
            entry["optimizer_" + key] = {"fused": fused[key],
                                         "loop": per_param[key]}
        nbytes = _update_bytes(net, dtype)
        entry["optimizer_bytes"] = nbytes
        entry["optimizer_bound_ms"] = _bytes_bound(card, nbytes)
        entry["optimizer_bound_share_fused"] = \
            entry["optimizer_bound_ms"] / fused["device_ms_per_step"]
        result[tag] = entry
        del net, trainer, loop
        torch.cuda.empty_cache()
    launches = _launches()  # read just after the path
    result["flash_attention_launches"] = launches
    check(launches == (0, 0, 0), "ResNet-50 Trainer launched flash "
          "attention kernels %s" % (launches,))

    x = nd.array(xs, ctx=mx.gpu(0))
    result["fused_equals_loop_fp32_tensors"] = _fused_equals_loop(None, x, y)
    torch.cuda.empty_cache()
    xb = nd.array(xs, ctx=mx.gpu(0), dtype="bfloat16")
    result["fused_equals_loop_bf16_mp_tensors"] = _fused_equals_loop(
        "bfloat16", xb, y)
    torch.cuda.empty_cache()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "mxnet_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="trainer-", dir=build)
    try:
        result["resume_states_bytes"] = _resume_equals_uninterrupted(
            x, y, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result["resume_equals_uninterrupted"] = True
    torch.cuda.empty_cache()
    log(json.dumps(result))
    return result


def phase_attention_trainer(card_line):
    """The attention layer through gluon.Trainer: adam, bf16 weights with
    fp32 masters, 10 steps on one batch (module docstring, phase 12)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.examples.attention_layer import SelfAttention

    units, steps = 1024, 10
    mx.random.seed(SEED)
    net = SelfAttention(units, heads=16)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net.cast("bfloat16")
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-3, "multi_precision": True})
    rng = np.random.default_rng(SEED)
    x = nd.array(rng.standard_normal((8, 2048, units), dtype=np.float32),
                 ctx=mx.gpu(0), dtype="bfloat16")
    y = nd.array(rng.standard_normal((8, 2048, units), dtype=np.float32),
                 ctx=mx.gpu(0))
    loss_fn = gluon.loss.L2Loss()
    losses, per_step, times = [], [], []
    _reset_launches()  # the main path starts here
    for _ in range(steps):
        before = _launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = _record_and_backward(net, x, y, True, loss_fn)
        trainer.step(8)
        losses.append(float(loss.asnumpy().mean()))
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append(tuple(a - b for a, b in zip(_launches(), before)))
    launches = _launches()  # read just after the path
    check(all(c == (1, 1, 1) for c in per_step),
          "Trainer: K1/K2/K3 launches per step %s, not once each" % per_step)
    check(all(np.isfinite(losses)), "non-finite loss %s" % losses)
    check(losses[-1] < losses[0], "the loss did not fall: %s" % losses)
    check(trainer._applier.num_compiles >= 1, "adam did not take the "
          "fused path")
    masters = list(trainer._updater.states.values())
    check(all(s[1]._data.dtype == torch.float32 for s in masters),
          "adam states are not (inner, fp32 master)")
    result = {"phase": "attention_layer_trainer", "card": card_line,
              "shape": [8, 16, 2048, 64], "dtype": "bfloat16",
              "optimizer": ["adam", {"learning_rate": 1e-3,
                                     "multi_precision": True}],
              "steps": steps, "losses": losses, "step_ms": times,
              "step_ms_median": float(np.median(times[2:])),
              "launches_per_step": per_step, "launches": launches}
    log(json.dumps(result))
    return launches, result["step_ms_median"]


# Phase 13: the input pipeline. Records, widths and protocol.
PIPE_RECORDS = 512
PIPE_SIDE = 256
PIPE_BATCH = 32
PIPE_SHAPE = (3, 224, 224)
PIPE_MEAN = (123.68, 116.28, 103.53)
PIPE_STD = (58.395, 57.12, 57.375)
# PCIe transfer rate per lane (GT/s) and line-code efficiency by gen.
PCIE_GT_S = {1: 2.5, 2: 5.0, 3: 8.0, 4: 16.0, 5: 32.0, 6: 64.0}


def _all_launches():
    """Every launch counter of the port's kernels: K1-K3, K4 (rtc), the
    fused BN+ReLU, the elementwise rtc kernels, and the detection kernels
    (D1, D2 forward, D2 backward)."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.examples import fused_bn_relu, rtc_kernels

    return {"k1_k2_k3": _launches(), "rtc": rtc.LAUNCHES,
            "bn_relu": fused_bn_relu.LAUNCHES,
            "scale_add": rtc_kernels.LAUNCHES["scale_add"],
            "relu": rtc_kernels.LAUNCHES["relu"],
            "d1_d2": _det_launches()}


def _reset_all_launches():
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.examples import fused_bn_relu, rtc_kernels

    _reset_launches()
    _reset_det_launches()
    rtc.LAUNCHES = 0
    fused_bn_relu.LAUNCHES = 0
    rtc_kernels.LAUNCHES["scale_add"] = rtc_kernels.LAUNCHES["relu"] = 0


def _write_records(tmpdir, n=PIPE_RECORDS, side=PIPE_SIDE, seed=SEED):
    """n PNG records of side x side x 3 noise, labels in [0, 1000), and
    their .idx, written with the port's recordio."""
    import os

    from mxnet_tpu_torch import recordio

    rng = np.random.RandomState(seed)
    rec = os.path.join(tmpdir, "train.rec")
    idx = os.path.join(tmpdir, "train.idx")
    writer = recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        img = rng.randint(0, 256, (side, side, 3), dtype=np.uint8)
        header = recordio.IRHeader(0, float(rng.randint(0, 1000)), i, 0)
        writer.write_idx(i, recordio.pack_img(header, img, img_fmt=".png"))
    writer.close()
    return rec, idx


def _pipeline(rec, ctx, place, seed=SEED, threads=4, random_aug=False):
    from mxnet_tpu_torch import data

    decoder = data.ImageRecordDecoder(
        PIPE_SHAPE, rand_crop=random_aug, rand_mirror=random_aug,
        mean=np.array(PIPE_MEAN), std=np.array(PIPE_STD), seed=seed)
    return data.DataPipeline(rec, decoder, PIPE_BATCH, shuffle=True,
                             seed=seed, decode_threads=threads, prefetch=2,
                             place=place, ctx=ctx)


def _record_iter(rec, idx, ctx, seed=SEED):
    import mxnet_tpu_torch as mx

    return mx.io.ImageRecordIter(
        path_imgrec=rec, path_imgidx=idx, data_shape=PIPE_SHAPE,
        batch_size=PIPE_BATCH, shuffle=True, preprocess_threads=4,
        mean_r=PIPE_MEAN[0], mean_g=PIPE_MEAN[1], mean_b=PIPE_MEAN[2],
        std_r=PIPE_STD[0], std_g=PIPE_STD[1], std_b=PIPE_STD[2], ctx=ctx,
        seed=seed)


def _card_equals_host(card_batches, host_batches, step, what):
    """Each batch delivered on the card, read back before and after a
    fp32 train step on it, equals the host pass's batch bit for bit."""
    bad = 0
    n = 0
    for got, want in zip(card_batches, host_batches):
        x, y = got.data[0], got.label[0]
        check(x.context.device_type == "gpu", "%s delivered on %s"
              % (what, x.context))
        before = torch.empty(x.shape, dtype=x.data_.dtype, pin_memory=True)
        before.copy_(x.data_, non_blocking=True)   # ordered after the copy
        step(x, y)
        after = x.data_.cpu()                       # after the step read it
        want_x = np.asarray(want.data[0])
        want_y = np.asarray(want.label[0])
        for arr in (before.numpy(), after.numpy()):
            bad += int(not np.array_equal(arr.view(np.uint32),
                                          want_x.view(np.uint32)))
        bad += int(not np.array_equal(y.asnumpy(), want_y))
        n += 1
    return n, bad


def _fed_rate(step, batches, warmup=3, windows=3, iters=10):
    """benchmark_rate's protocol over batches from a data source: warmup
    steps, then the median img/s of windows of `iters` steps, each
    closed by a host readback of the loss; and the data-wait share of
    the windows (time blocked in next() over wall time) beside
    ``stall_fraction`` of the spans recorded in them."""
    from mxnet_tpu_torch.data import stall_fraction
    from mxnet_tpu_torch.telemetry import trace

    it = iter(batches)

    def pull():
        b = next(it)
        return (b.data[0], b.label[0]) if hasattr(b, "data") else b

    loss = None
    for _ in range(warmup):
        loss = step(*pull())
    float(loss)
    trace.clear()
    rates, waited, wall = [], 0.0, 0.0
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            t1 = time.perf_counter()
            x, y = pull()
            waited += time.perf_counter() - t1
            loss = step(x, y)
        float(loss)
        dt = time.perf_counter() - t0
        wall += dt
        rates.append(PIPE_BATCH * iters / dt)
    return {"img_s": sorted(rates)[len(rates) // 2],
            "data_wait_share": waited / wall,
            "stall_fraction": stall_fraction(),
            "loss": float(loss)}


class _DecodeSample:
    """DataLoader worker body: one PNG record to (CHW float32, label)
    through `augs` (host numpy only)."""

    def __init__(self, augs):
        self.augs = augs

    def __call__(self, record):
        from mxnet_tpu_torch import recordio
        from mxnet_tpu_torch.image import image as img_mod

        header, payload = recordio.unpack(record)
        img = img_mod._imdecode_np(payload)      # RGB, as the iterators
        for aug in self.augs:
            img = aug(img)
        return (np.ascontiguousarray(np.asarray(img, np.float32)
                                     .transpose(2, 0, 1)),
                np.float32(header.label))


def _loader_batches(rec, workers, epochs=100):
    """Batches of a process-pool DataLoader over the raw records, each
    decoded (random crop and mirror, normalized) in a worker, pinned and
    copied to gpu(0)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.image import image as img_mod

    augs = img_mod.CreateAugmenter(
        PIPE_SHAPE, rand_crop=True, rand_mirror=True,
        mean=np.array(PIPE_MEAN), std=np.array(PIPE_STD))
    ds = gluon.data.RecordFileDataset(rec).transform(_DecodeSample(augs))
    loader = gluon.data.DataLoader(ds, PIPE_BATCH, shuffle=True,
                                   last_batch="discard",
                                   num_workers=workers, pin_memory=True)

    def gen():
        for _ in range(epochs):
            for x, y in loader:
                yield x, y
    return loader, gen()


def _upload_times():
    """One 19.27 MB batch (32x3x224x224 fp32) host to card: pinned
    against pageable, CUDA-event median of 10, beside the link's bound."""
    x = torch.from_numpy(np.random.RandomState(SEED).rand(
        PIPE_BATCH, *PIPE_SHAPE).astype(np.float32))
    pinned = x.pin_memory()
    dev = torch.empty(x.shape, device="cuda")
    nbytes = x.numel() * 4
    out = {"bytes": nbytes}
    for tag, src in (("pageable_ms", x), ("pinned_ms", pinned),
                     ("pinned_ms_2", pinned), ("pageable_ms_2", x)):
        out[tag] = time_ms(lambda: dev.copy_(src, non_blocking=True),
                           iters=10)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.current,"
         "pcie.link.width.current,pcie.link.gen.max,pcie.link.width.max",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out["nvidia_smi_pcie"] = smi
    fields = [v.strip() for v in smi.split(",")]
    links = [(fields[0], fields[1], "nvidia-smi current"),
             (fields[2], fields[3], "nvidia-smi max"),
             # Where the card reports neither: the H100 SXM5 data sheet.
             ("5", "16", "data sheet (nvidia-smi reads N/A)")]
    gen, width, source = next((int(g), int(w), src) for g, w, src in links
                              if g.isdigit() and w.isdigit())
    rate = PCIE_GT_S[gen] * 1e9 * width * (128 / 130 if gen >= 3 else 0.8) / 8
    out["link"] = "PCIe gen%d x%d (%s)" % (gen, width, source)
    out["link_bound_ms"] = nbytes / rate * 1e3
    out["pinned_share_of_bound"] = out["link_bound_ms"] / min(
        out["pinned_ms"], out["pinned_ms_2"])
    return out


def phase_input_pipeline(card_line, synthetic):
    """ResNet-50 v1 at full width trained from a .rec: 512 PNG records
    of 256x256x3 noise written with the port's recordio; DataPipeline
    (4 decode threads, prefetch 2, place=True: pinned staging and a
    side-stream copy to gpu(0)) and ImageRecordIter, each batch on the
    card held bit for bit against the same source's host pass while a
    b32 fp32 TrainStep runs on it; the pipeline's img/s at 1, 4 and 8
    decode threads; one batch's upload pinned against pageable beside
    the link's bound; ResNet-50 train img/s fed by the pipeline (fp32,
    bf16) and, bf16, by a process-pool DataLoader, beside phase 7's
    synthetic img/s, with the data-wait share of each; the gluon loop
    (DataLoader, pin_memory, gluon.Trainer) at its own configuration.
    The native RecordIO reader must be the one that ran."""
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import recordio_native
    from mxnet_tpu_torch.examples import gluon_image_classification as gic
    from mxnet_tpu_torch.examples import train_imagenet

    check(recordio_native.available(), "the native RecordIO reader did "
          "not build on this host")
    result = {"phase": "input_pipeline", "card": card_line,
              "records": PIPE_RECORDS, "record_shape": [PIPE_SIDE,
                                                         PIPE_SIDE, 3],
              "batch": PIPE_BATCH}
    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_rec_")
    try:
        t0 = time.perf_counter()
        rec, idx = _write_records(tmpdir)
        result["write_s"] = time.perf_counter() - t0
        log("phase 13: wrote %d records in %.1f s"
            % (PIPE_RECORDS, result["write_s"]))
        result["rec_mb"] = __import__("os").path.getsize(rec) / 1e6
        _reset_all_launches()   # the main path starts here
        reads0 = recordio_native.READS
        gpu, host = mx.gpu(0), mx.cpu()
        mx.random.seed(SEED)
        step = train_imagenet.build_train_step("resnet50", device=gpu)
        # Gate: the card's copy equals the host bytes, under a step.
        t0 = time.perf_counter()
        with _pipeline(rec, host, place=False) as pipe:
            want = [next(pipe) for _ in range(PIPE_RECORDS // PIPE_BATCH)]
        with _pipeline(rec, gpu, place=True) as pipe:
            got = (next(pipe) for _ in range(len(want)))
            n, bad = _card_equals_host(got, want, step, "DataPipeline")
        check(n == len(want) and bad == 0, "DataPipeline: %d of %d batches "
              "on the card differ from the host pass" % (bad, n))
        it_host = _record_iter(rec, idx, host)
        want = [b for b in it_host]
        it_host.close()
        it_card = _record_iter(rec, idx, gpu)
        n, bad = _card_equals_host(it_card, want, step, "ImageRecordIter")
        it_card.close()
        check(n == len(want) == PIPE_RECORDS // PIPE_BATCH and bad == 0,
              "ImageRecordIter: %d of %d batches on the card differ from "
              "the host pass" % (bad, n))
        log("phase 13: gate passed, %.1f s" % (time.perf_counter() - t0))
        result["gate"] = {"datapipeline_batches": len(want),
                          "imagerecorditer_batches": n, "mismatches": 0,
                          "seconds": time.perf_counter() - t0}
        # The pipeline alone, rand crop + mirror, copy included.
        result["pipeline_img_s"] = {}
        for threads in (1, 4, 8):
            with _pipeline(rec, gpu, True, threads=threads,
                           random_aug=True) as pipe:
                next(pipe)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(PIPE_RECORDS // PIPE_BATCH):
                    batch = next(pipe)
                batch.data[0].wait_to_read()
                result["pipeline_img_s"][threads] = \
                    PIPE_RECORDS / (time.perf_counter() - t0)
        log("phase 13: pipeline alone", result["pipeline_img_s"])
        result["upload"] = _upload_times()
        # ResNet-50 fed by the pipeline (threads) and a DataLoader
        # (processes), beside phase 7's synthetic rates.
        fed = {}
        for tag, dtype in (("fp32", None), ("bf16", "bfloat16")):
            mx.random.seed(SEED)
            s = train_imagenet.build_train_step("resnet50", dtype=dtype,
                                                device=gpu)
            with _pipeline(rec, gpu, True, random_aug=True) as pipe:
                fed[tag] = _fed_rate(s, pipe, windows=1)
            fed[tag]["synthetic_img_s"] = synthetic[tag]["img_s_b32"]
            log("phase 13: fed", tag, fed[tag])
        mx.random.seed(SEED)
        s = train_imagenet.build_train_step("resnet50", dtype="bfloat16",
                                            device=gpu)
        loader, batches = _loader_batches(rec, workers=4)
        try:
            fed["bf16_dataloader_4_workers"] = _fed_rate(s, batches,
                                                         windows=1)
        finally:
            loader.close()
        # The DataLoader records no data::wait spans: its wait is the
        # share measured around next().
        del fed["bf16_dataloader_4_workers"]["stall_fraction"]
        fed["bf16_dataloader_4_workers"]["synthetic_img_s"] = \
            synthetic["bf16"]["img_s_b32"]
        log("phase 13: fed by the DataLoader",
            fed["bf16_dataloader_4_workers"])
        result["train_fed"] = fed
        result["native_reads"] = recordio_native.READS - reads0
        check(result["native_reads"] >= 2 * PIPE_RECORDS, "the pipeline "
              "read %d records through the native reader"
              % result["native_reads"])
        # The gluon loop at its own configuration, with cuDNN's
        # deterministic algorithms: its loss check reads the mean loss of
        # five epochs of a seeded run, which nondeterministic
        # convolutions made differ from run to run (near zero, a spike
        # in the last epoch read above the first in one run of three).
        result["gluon_loop"] = {}
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for workers in (0, 4):
                t0 = time.perf_counter()
                run = gic.run(num_workers=workers, pin_memory=True, ctx=gpu)
                run["seconds"] = time.perf_counter() - t0
                losses = [e["loss"] for e in run["epochs"]]
                check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                      "the gluon loop's loss did not fall (workers %d): %s"
                      % (workers, losses))
                result["gluon_loop"][workers] = run
                log("phase 13: gluon loop, %d workers, %.1f s, losses %s"
                    % (workers, run["seconds"], losses))
        finally:
            torch.backends.cudnn.deterministic = deterministic
        launches = _all_launches()   # read just after the path
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    result["launches"] = launches
    check(launches["k1_k2_k3"] == (0, 0, 0) and launches["rtc"] == 0,
          "the input pipeline launched kernels %s" % (launches,))
    log(json.dumps(result))
    return result


# -- slice 9: checkpoint and the Module API ----------------------------------

CKPT_KEEP_LAST = 2
CKPT_STEPS = 4          # bit-exact resume: save every step, restore step 2
CKPT_RESTORE = 2
SIGTERM_AT_PARAM = 80   # phase 14's in-step SIGTERM: the k-th parameter


def _state_bytes(tree):
    """Bytes of the arrays and bytes leaves of a nested state."""
    n = 0
    for v in tree.values():
        if isinstance(v, dict):
            n += _state_bytes(v)
        elif isinstance(v, torch.Tensor):
            n += v.numel() * v.element_size()
        elif isinstance(v, (bytes, bytearray)):
            n += len(v)
    return n


def _fs_info(path):
    import shutil

    usage = shutil.disk_usage(path)
    fstype = subprocess.run(["stat", "-f", "-c", "%T", path],
                            capture_output=True, text=True,
                            timeout=60).stdout.strip()
    return {"dir": path, "free_gb": usage.free / 1e9,
            "total_gb": usage.total / 1e9, "fs_type": fstype}


def _spans_ms(events, name):
    return [e["dur"] / 1e3 for e in events
            if e.get("ph") == "X" and e.get("name") == name]


def _stats(values):
    if not values:
        return None
    v = sorted(values)
    return {"n": len(v), "median": v[len(v) // 2], "mean": sum(v) / len(v),
            "min": v[0], "max": v[-1]}


def _ckpt_rate(step, x, y, tmpdir, every, warmup=3, windows=3, iters=10):
    """benchmark_rate's protocol (warmup steps, then the median img/s of
    `windows` windows of `iters` steps, each closed by a host readback of
    the loss) with an async ``CheckpointManager.save`` of the step's
    state every `every` steps (0: none), keep_last=2; then the writer's
    figures, read from its trace spans and totals after it drained."""
    import os
    import shutil

    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.telemetry import trace

    d = os.path.join(tmpdir, "every-%d-%d" % (every, step.num_update))
    mgr = CheckpointManager(d, keep_last=CKPT_KEEP_LAST)
    loss = None
    for _ in range(warmup):
        loss = step(x, y)
    float(loss)
    trace.clear()
    rates, save_ms, state_ms = [], [], []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            loss = step(x, y)
            if every and step.num_update % every == 0:
                t1 = time.perf_counter()
                state = step.state_dict()
                t2 = time.perf_counter()
                mgr.save(step.num_update, state)
                del state
                state_ms.append((t2 - t1) * 1e3)
                save_ms.append((time.perf_counter() - t2) * 1e3)
        float(loss)
        rates.append(x.shape[0] * iters / (time.perf_counter() - t0))
    t_wait = time.perf_counter()
    mgr.wait()
    wait_s = time.perf_counter() - t_wait
    events = trace.chrome_trace()["traceEvents"]
    out = {"every": every, "img_s_b32": sorted(rates)[len(rates) // 2],
           "img_s_windows": rates, "loss": float(loss)}
    if every:
        commits = mgr.all_steps()
        out.update({
            "saves_requested": len(save_ms),
            "dropped_saves": mgr.dropped_saves,
            "state_dict_ms": _stats(state_ms),
            "save_call_ms": _stats(save_ms),
            "snapshot_span_ms": _stats(_spans_ms(events,
                                                 "checkpoint::snapshot")),
            "write_span_ms": _stats(_spans_ms(events, "checkpoint::write")),
            "commit_span_ms": _stats(_spans_ms(events,
                                               "checkpoint::commit")),
            "writer_bytes": mgr.total_bytes,
            "writer_seconds": mgr.total_save_seconds,
            "writer_mb_s": mgr.total_bytes / 1e6
            / max(mgr.total_save_seconds, 1e-9),
            "drain_after_windows_s": wait_s,
            "committed_steps": commits,
            "last_error": repr(mgr.last_error)})
        check(mgr.last_error is None, "checkpoint writer failed: %r"
              % (mgr.last_error,))
        check(commits and commits[-1] == step.num_update,
              "the newest save (step %d) did not commit: %s"
              % (step.num_update, commits))
    mgr.close()
    shutil.rmtree(d, ignore_errors=True)
    return out


def _pageable_copy_ms(state, reps=3):
    """The state's tensors copied to pageable host memory, one .cpu()
    each (what a snapshot without pinned staging costs)."""
    flat = []

    def walk(t):
        for v in t.values():
            if isinstance(v, dict):
                walk(v)
            elif isinstance(v, torch.Tensor):
                flat.append(v)
    walk(state)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = [v.cpu() for v in flat]
        times.append((time.perf_counter() - t0) * 1e3)
        del host
    return sorted(times)[len(times) // 2]


def _equal_trees(a, b, where=""):
    """Names of the leaves that differ bit for bit between two states."""
    bad = []
    for k in set(a) | set(b):
        u, v = a.get(k), b.get(k)
        name = where + k
        if isinstance(u, dict) and isinstance(v, dict):
            bad += _equal_trees(u, v, name + "/")
        elif isinstance(u, torch.Tensor) and isinstance(v, torch.Tensor):
            if u.dtype != v.dtype or u.shape != v.shape or \
                    not torch.equal(u.cpu(), v.cpu()):
                bad.append(name)
        elif u != v:
            bad.append(name)
    return bad


def _resnet_batches(n, batch=32, seed=SEED, dtype=None):
    """`n` synthetic ImageNet batches on gpu(0): images uniform in [0, 1),
    labels in [0, 1000)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.random((batch, 3, 224, 224), dtype=np.float32)
        y = rng.integers(0, 1000, batch).astype(np.float32)
        out.append((nd.array(x, ctx=mx.gpu(0), dtype=dtype or "float32"),
                    nd.array(y, ctx=mx.gpu(0))))
    return out


def _fresh_names():
    """Restart gluon's per-class block counters, as a new process starts
    them: a net built next gets the parameter names the first net of a
    process gets (names are counter based, ROADMAP Queue 3), which a
    TrainStep state is keyed by."""
    from mxnet_tpu_torch.gluon.block import _BlockScope

    _BlockScope._counters.clear()


def _trainstep_resume(tmpdir, batches):
    """4 TrainStep steps saving each, step 2 restored into a fresh step
    (other random weights) and 2 more steps, against 4 uninterrupted
    steps, bit for bit; and the uninterrupted run repeated (a control of
    the card's determinism)."""
    import os

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.examples import train_imagenet

    def build(seed):
        _fresh_names()
        mx.random.seed(seed)
        return train_imagenet.build_train_step("resnet50", device=mx.gpu(0))

    def run(step, items):
        for x, y in items:
            step(x, y)

    ref = build(SEED)
    run(ref, batches)
    want = ref.state_dict()
    del ref
    again = build(SEED)
    run(again, batches)
    control = _equal_trees(again.state_dict(), want)
    del again
    mgr = CheckpointManager(os.path.join(tmpdir, "trainstep"),
                            keep_last=CKPT_STEPS)
    first = build(SEED)
    for i, (x, y) in enumerate(batches):
        first(x, y)
        mgr.save(i + 1, first.state_dict())
    mgr.wait()
    del first
    step, state = mgr.restore(step=CKPT_RESTORE)
    resumed = build(SEED + 1)
    resumed(*batches[0])                   # shapes exist; then overwritten
    resumed.load_state_dict(state)
    check(resumed.num_update == CKPT_RESTORE, "restored num_update %d"
          % resumed.num_update)
    run(resumed, batches[CKPT_RESTORE:])
    bad = _equal_trees(resumed.state_dict(), want)
    mgr.close()
    return {"restored_step": step, "steps": CKPT_STEPS,
            "mismatches": bad[:8], "n_mismatches": len(bad),
            "uninterrupted_repeat_mismatches": len(control),
            "bitexact": not bad}


def _trainer_resume(tmpdir, batches):
    """The same for a bf16 net with multi_precision through gluon.Trainer,
    checkpointed as state_dict(net) + state_dict(trainer): the restored
    weights are bfloat16 and the 2 steps after the restore equal the
    uninterrupted 4 bit for bit."""
    import os

    from mxnet_tpu_torch import checkpoint, gluon
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    opt = dict(TRAINER_OPT, multi_precision=True)

    def build(seed):
        net = _resnet50(seed=seed, dtype="bfloat16")
        return net, gluon.Trainer(net.collect_params(), "sgd", dict(opt))

    def run(net, trainer, items):
        for x, y in items:
            _record_and_backward(net, x, y, cast_out=True)
            trainer.step(x.shape[0])

    def state(net, trainer):
        return {"net": checkpoint.state_dict(net),
                "trainer": checkpoint.state_dict(trainer)}

    def tensors(net, trainer):
        """Weights, and each optimizer state tensor (momentum, fp32
        master) by index."""
        return {"w": {k: p.data()._data.clone() for k, p in
                      net._collect_params_with_prefix().items()},
                "states": {"%d.%d" % (i, j): t.clone() for i, ts in
                           _state_tensors(trainer).items()
                           for j, t in enumerate(ts)}}

    net, tr = build(SEED)
    run(net, tr, batches)
    want = tensors(net, tr)
    del net, tr
    mgr = CheckpointManager(os.path.join(tmpdir, "trainer"),
                            keep_last=CKPT_STEPS)
    net, tr = build(SEED)
    sizes = None
    for i, item in enumerate(batches):
        run(net, tr, [item])
        st = state(net, tr)
        sizes = {"net_bytes": _state_bytes(st["net"]),
                 "trainer_pickle_bytes": len(st["trainer"]["opt_states"])}
        mgr.save(i + 1, st)
    mgr.wait()
    del net, tr
    step, st = mgr.restore(step=CKPT_RESTORE)
    net, tr = build(SEED + 1)
    checkpoint.load_state_dict(net, st["net"])
    checkpoint.load_state_dict(tr, st["trainer"])
    dtypes = sorted({str(p.data()._data.dtype)
                     for p in net.collect_params().values()})
    check(dtypes == ["torch.bfloat16"], "restored weights are %s" % dtypes)
    run(net, tr, batches[CKPT_RESTORE:])
    bad = _equal_trees(tensors(net, tr), want)
    mgr.close()
    return dict(sizes, restored_step=step, restored_dtypes=dtypes,
                mismatches=bad[:8], n_mismatches=len(bad), bitexact=not bad)


def _sigterm_in_update(tmpdir, x, y):
    """One ResNet-50 TrainStep step with a SIGTERM sent from inside its
    update loop (at parameter SIGTERM_AT_PARAM of 161): the preemption
    hook's commit equals the pre- or post-step state bit for bit, under
    that state's step."""
    import os
    import signal

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.checkpoint import CheckpointManager, PreemptionHook
    from mxnet_tpu_torch.examples import train_imagenet

    mx.random.seed(SEED)
    step = train_imagenet.build_train_step("resnet50", device=mx.gpu(0))
    step(x, y)
    pre = step.state_dict()
    real = step._opt_update
    calls = {"n": 0}

    def update(*args):
        calls["n"] += 1
        if calls["n"] == SIGTERM_AT_PARAM:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(*args)

    step._opt_update = update
    mgr = CheckpointManager(os.path.join(tmpdir, "sigterm"))
    hook = PreemptionHook(mgr, state_fn=step.state_dict,
                          step_fn=lambda: step.num_update, exit=False,
                          snapshot_retry_delay=0.05)
    t0 = time.perf_counter()
    with hook:
        step(x, y)
        deadline = time.monotonic() + 60
        while hook.saved_step is None and time.monotonic() < deadline:
            time.sleep(0.02)
    seconds = time.perf_counter() - t0
    check(hook.saved_step is not None, "the preemption save never landed")
    post = step.state_dict()
    saved, state = mgr.restore()

    def as_tensors(tree):
        return {k: as_tensors(v) if isinstance(v, dict) else
                (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                for k, v in tree.items()}

    got = as_tensors(state)
    got.pop("rng")
    whole = []
    for tag, want in (("pre", pre), ("post", post)):
        want = {k: v for k, v in want.items() if k != "rng"}
        if not _equal_trees(got, want) and saved == want["num_update"]:
            whole.append(tag)
    check(whole, "the SIGTERM commit (step %d) mixes two steps" % saved)
    mgr.close()
    return {"signal_at_parameter": SIGTERM_AT_PARAM,
            "committed_step": saved, "equals": whole[0],
            "seconds_to_commit": seconds}


def phase_checkpoint(card_line):
    """Phase 14: fault-tolerant checkpoints of ResNet-50 v1 training at
    full width (see the module docstring)."""
    import os
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples import train_imagenet, train_resume

    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    result = {"phase": "checkpoint", "card": card_line, "batch": 32,
              "optimizer": ["sgd", TRAINER_OPT], "keep_last":
              CKPT_KEEP_LAST, "fs": _fs_info(tmpdir)}
    try:
        _reset_all_launches()   # the main path starts here
        mx.random.seed(SEED)
        step = train_imagenet.build_train_step("resnet50", device=mx.gpu(0))
        (x, y), = _resnet_batches(1)
        step(x, y)
        state = step.state_dict()
        result["trainstep_state_bytes"] = _state_bytes(state)
        result["pageable_copy_ms"] = _pageable_copy_ms(state)
        del state
        # One warning per dropped save would bury the results: the
        # count is in each reading.
        import logging
        logging.getLogger("mxnet_tpu_torch.checkpoint.manager").setLevel(
            logging.ERROR)
        # 3 + 10 = 13 steps a configuration: the every-10 one ends at
        # step 1 + 3 x 13 = 40, a multiple of 10, so its newest commit
        # is its last step.
        rates = [_ckpt_rate(step, x, y, tmpdir, every, windows=1)
                 for every in (0, 1, 10, 0)]
        logging.getLogger("mxnet_tpu_torch.checkpoint.manager").setLevel(
            logging.NOTSET)
        result["rates"] = rates
        log("phase 14: img/s no saves %.1f/%.1f, every step %.1f, every 10 "
            "%.1f" % (rates[0]["img_s_b32"], rates[3]["img_s_b32"],
                      rates[1]["img_s_b32"], rates[2]["img_s_b32"]))
        del step
        torch.cuda.empty_cache()
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            batches = _resnet_batches(CKPT_STEPS, seed=SEED + 1)
            result["trainstep_resume"] = _trainstep_resume(tmpdir, batches)
            bf16 = [(x.astype("bfloat16"), y) for x, y in batches]
            result["trainer_bf16_resume"] = _trainer_resume(tmpdir, bf16)
            del bf16
        finally:
            torch.backends.cudnn.deterministic = deterministic
        torch.cuda.empty_cache()
        result["trainer_bf16_state_bytes"] = \
            result["trainer_bf16_resume"]["net_bytes"] + \
            result["trainer_bf16_resume"]["trainer_pickle_bytes"]
        result["sigterm_in_update"] = _sigterm_in_update(tmpdir, x, y)
        t0 = time.perf_counter()
        result["train_resume_demo"] = train_resume.main(
            ["--steps", "16", "--kill-after", "6", "--step-delay", "0.1"])
        result["train_resume_demo"]["seconds"] = time.perf_counter() - t0
        launches = _all_launches()   # read just after the path
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    result["launches"] = launches
    log(json.dumps(result))
    for key in ("trainstep_resume", "trainer_bf16_resume"):
        check(result[key]["bitexact"], "%s: the resumed run differs from "
              "the uninterrupted one at %s" % (key,
                                               result[key]["mismatches"]))
    check(result["train_resume_demo"]["bitexact"]
          and result["train_resume_demo"]["exit_code"] == 143,
          "train_resume: %s" % result["train_resume_demo"])
    return result


def _module_symbol(net, tmpdir):
    """The gluon net exported, with SoftmaxOutput(name="softmax") on its
    logits; and the exported arg/aux params."""
    import os

    import mxnet_tpu_torch as mx

    prefix = os.path.join(tmpdir, "resnet50_v1")
    net.export(prefix)
    sym = mx.sym.SoftmaxOutput(mx.sym.load(prefix + "-symbol.json"),
                               name="softmax")
    arg, aux = mx.model.load_params(prefix, 0, ctx=mx.gpu(0))
    return sym, arg, aux


class _FitWindows:
    """Batch-end callback timing Module.fit with benchmark_rate's
    protocol: `warmup` batches, then windows of `iters` batches, each
    closed by a synchronization of the card."""

    def __init__(self, batch, warmup=3, iters=16):
        self.batch, self.warmup, self.iters = batch, warmup, iters
        self.rates = []
        self.t0 = None

    def __call__(self, param):
        done = param.nbatch + 1
        if done < self.warmup or (done > self.warmup and
                                  (done - self.warmup) % self.iters):
            return
        torch.cuda.synchronize()
        now = time.perf_counter()
        if done > self.warmup:
            self.rates.append(self.batch * self.iters / (now - self.t0))
        self.t0 = now


def _peak_mb(fn):
    """(peak MB above the allocation before `fn`, absolute peak MB)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return (peak - base) / 1e6, peak / 1e6


def _module_f64_parity(w0_net, tmpdir):
    """One SGD step at PARITY_BATCH in float64 from the same weights
    through Module (float64 arrays) and TrainStep(dtype="float64", fp32
    masters) on the card: loss-free comparison of weights, momentum and
    running stats with PARITY_LIMITS' float64 terms."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.io import DataBatch, DataDesc
    from mxnet_tpu_torch.parallel import TrainStep, make_mesh

    lim = PARITY_LIMITS
    rng = np.random.default_rng(SEED + 7)
    xs = rng.random((PARITY_BATCH, 3, 224, 224), dtype=np.float32)
    ys = rng.integers(0, 1000, PARITY_BATCH).astype(np.float32)
    sym, arg, aux = _module_symbol(w0_net, tmpdir)
    w0 = {n: v.asnumpy().astype(np.float64) for n, v in arg.items()}
    ts = TrainStep(w0_net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                   dict(TRAINER_OPT),
                   mesh=make_mesh({"dp": 1}, devices=[mx.gpu(0)]),
                   dtype="float64")
    ts(xs, ys)
    params, states, t_aux = ts.state_to_host()
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    mod.bind(data_shapes=[DataDesc("data", xs.shape, np.float64)],
             label_shapes=[DataDesc("softmax_label", ys.shape)])
    mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(TRAINER_OPT))
    mod.forward(DataBatch(data=[mx.nd.array(xs, ctx=mx.gpu(0),
                                            dtype="float64")],
                          label=[mx.nd.array(ys, ctx=mx.gpu(0))]),
                is_train=True)
    mod.backward()
    mod.update()
    m_arg, m_aux = mod.get_params()
    m_w = {n: v.asnumpy() for n, v in m_arg.items()}
    m_mom = {mod._param_names[i]: s.asnumpy()
             for i, s in mod._updater.states.items()}
    m_aux = {n: v.asnumpy() for n, v in m_aux.items()}
    check(all(v.dtype == np.float64 for v in m_w.values()),
          "the float64 Module holds %s weights"
          % {str(v.dtype) for v in m_w.values()})
    mom = _rel_max({n: s[0] for n, s in states.items()}, m_mom)
    auxe = _rel_max(t_aux, m_aux)
    weight_excess = max(
        float((np.abs(params[n] - w) - lim["f64_weight_rtol"]
               * np.abs(w)).max())
        / max(float(np.abs(w - w0[n]).max()), 1e-30)
        for n, w in m_w.items())
    reading = {"batch": PARITY_BATCH, "params": len(m_w),
               "momentum_rel_max": max(mom.values()),
               "aux_rel_max": max(auxe.values()),
               "weight_excess_over_step": weight_excess,
               "limits": {k: lim[k] for k in ("f64_momentum", "f64_aux",
                                              "f64_weight_rtol",
                                              "f64_weight_step")}}
    reading["within"] = (reading["momentum_rel_max"] <= lim["f64_momentum"]
                         and reading["aux_rel_max"] <= lim["f64_aux"]
                         and weight_excess <= lim["f64_weight_step"])
    return reading


def _module_resume(sym_arg_aux, batches, tmpdir):
    """Module.fit for 2 epochs of 2 b32 batches, against 1 epoch,
    save_checkpoint(save_optimizer_states=True) (module_checkpoint),
    Module.load and fit(begin_epoch=1): params and aux bit for bit."""
    import os

    import mxnet_tpu_torch as mx

    sym, arg, aux = sym_arg_aux
    gpu = mx.gpu(0)
    x = np.concatenate([b[0] for b in batches])
    y = np.concatenate([b[1] for b in batches])

    def it():
        return mx.io.NDArrayIter(x, y, batch_size=32, ctx=gpu)

    def fit(mod, begin, end, **kw):
        mod.fit(it(), begin_epoch=begin, num_epoch=end, optimizer="sgd",
                optimizer_params=dict(TRAINER_OPT), **kw)

    def params(mod):
        a, x_ = mod.get_params()
        return {"arg": {k: v._data.clone() for k, v in a.items()},
                "aux": {k: v._data.clone() for k, v in x_.items()}}

    ref = mx.mod.Module(sym, context=gpu)
    fit(ref, 0, 2, arg_params=arg, aux_params=aux)
    want = params(ref)
    del ref
    prefix = os.path.join(tmpdir, "module_resume")
    first = mx.mod.Module(sym, context=gpu)
    fit(first, 0, 1, arg_params=arg, aux_params=aux,
        epoch_end_callback=mx.callback.module_checkpoint(
            first, prefix, save_optimizer_states=True))
    del first
    resumed = mx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                 context=gpu)
    fit(resumed, 1, 2)
    bad = _equal_trees(params(resumed), want)
    return {"epochs": 2, "batches_per_epoch": len(batches),
            "mismatches": bad[:8], "n_mismatches": len(bad),
            "states_bytes": os.path.getsize(prefix + "-0001.states"),
            "bitexact": not bad}


def phase_module(card_line, trainer_img_s):
    """Phase 15: ResNet-50 v1 at full width through Module.fit (see the
    module docstring)."""
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon

    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_module_")
    warmup, windows, iters = 3, 3, 16
    result = {"phase": "module", "card": card_line, "batch": 32,
              "optimizer": ["sgd", TRAINER_OPT], "windows": windows,
              "iters_per_window": iters, "eval_metric": "acc"}
    try:
        _reset_all_launches()   # the main path starts here
        net = _resnet50(seed=SEED)
        sym, arg, aux = _module_symbol(net, tmpdir)
        rng = np.random.default_rng(SEED)
        distinct = 8
        xs = rng.random((distinct * 32, 3, 224, 224), dtype=np.float32)
        ys = rng.integers(0, 1000, distinct * 32).astype(np.float32)
        n_batches = warmup + windows * iters
        reps = -(-n_batches // distinct)
        xs_all = np.tile(xs, (reps, 1, 1, 1))[:n_batches * 32]
        ys_all = np.tile(ys, reps)[:n_batches * 32]
        timer = _FitWindows(32, warmup, iters)
        # Bound and initialized first, so the peak below counts what a
        # batch adds, as the Trainer's does (its net exists before).
        mod = mx.mod.Module(sym, context=mx.gpu(0))
        mod.bind(data_shapes=[("data", (32, 3, 224, 224))],
                 label_shapes=[("softmax_label", (32,))])
        mod.init_params(arg_params=arg, aux_params=aux)
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=dict(TRAINER_OPT))

        def fit():
            mod.fit(mx.io.NDArrayIter(xs_all, ys_all, batch_size=32,
                                      ctx=mx.gpu(0)),
                    num_epoch=1, batch_end_callback=timer)

        t0 = time.perf_counter()
        peak = _peak_mb(fit)
        check(len(timer.rates) == windows, "timed %d windows"
              % len(timer.rates))
        result["module_fit"] = {
            "img_s_b32": sorted(timer.rates)[len(timer.rates) // 2],
            "img_s_windows": timer.rates, "seconds": time.perf_counter()
            - t0, "peak_mb_above_base": peak[0], "peak_mb": peak[1],
            "fused_plans": mod._fused_applier.num_compiles}
        check(mod._fused_applier.num_compiles >= 1, "Module.update did not "
              "take the fused path")
        del mod, xs_all, ys_all
        trainer_net = _resnet50(seed=SEED)
        trainer = gluon.Trainer(trainer_net.collect_params(), "sgd",
                                dict(TRAINER_OPT))
        x = mx.nd.array(xs[:32], ctx=mx.gpu(0))
        y = mx.nd.array(ys[:32], ctx=mx.gpu(0))

        def trainer_steps():
            for _ in range(3):
                _record_and_backward(trainer_net, x, y)
                trainer.step(32)

        peak = _peak_mb(trainer_steps)
        result["trainer_peak_mb_above_base"] = peak[0]
        result["trainer_peak_mb"] = peak[1]
        result["trainer_img_s_b32_phase11"] = trainer_img_s
        del trainer_net, trainer
        torch.cuda.empty_cache()
        log("phase 15: Module.fit %.1f img/s (Trainer %.1f in phase 11), "
            "peak %.0f MB above base (Trainer %.0f)"
            % (result["module_fit"]["img_s_b32"], trainer_img_s,
               result["module_fit"]["peak_mb_above_base"],
               result["trainer_peak_mb_above_base"]))
        result["f64_parity"] = _module_f64_parity(net, tmpdir)
        torch.cuda.empty_cache()
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            batches = [(xs[i * 32:(i + 1) * 32], ys[i * 32:(i + 1) * 32])
                       for i in range(2)]
            result["resume"] = _module_resume((sym, arg, aux), batches,
                                              tmpdir)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        launches = _all_launches()   # read just after the path
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    result["launches"] = launches
    log(json.dumps(result))
    check(result["f64_parity"]["within"], "Module vs TrainStep float64 step: "
          "%s" % result["f64_parity"])
    check(result["resume"]["bitexact"], "Module resume differs at %s"
          % result["resume"]["mismatches"])
    return result


# -- slice 10: the recurrent path ---------------------------------------------

# The bucketed LSTM LM of the reference's lstm_bucketing.py: PTB's
# vocabulary, embedding 200, two LSTM layers of 200, batch 32, buckets
# 10-60, adam lr 0.01 wd 1e-5; the port's synthetic corpus from SEED.
LM = {"vocab": 10000, "embed": 200, "hidden": 200, "layers": 2,
      "batch": 32, "buckets": (10, 20, 30, 40, 50, 60), "sentences": 3200,
      "epochs": 4, "optimizer": "adam", "lr": 0.01, "wd": 1e-5}
# The gate: after LM["epochs"] epochs the perplexity that Module.score
# reads over the corpus is at most 1/5 of the perplexity it reads at
# initialization.
LM_PPL_FACTOR = 5.0
# fp32 (TF32 off) comparisons of two computations of one function in
# another summation order (a foreach over LSTMCell against the fused op;
# cuDNN's LSTM against the op): values within rtol 1e-4 / atol 1e-5,
# gradients within rtol 1e-4 and 1e-4 of the tensor's largest entry.
RNN_TOL = {"rtol": 1e-4, "atol": 1e-5, "grad_atol_rel": 1e-4}
# The card's fp32 LM step against float64, as the host's fp32 step is:
# per tensor at most 4x the host's error plus 1e-3 of the step's
# largest entry, and over the net (relative L2) at most 4x.
LM_PARITY = {"fp32_update_ratio": 4.0, "fp32_update_floor": 1e-3,
             "fp32_update_l2_ratio": 4.0}


class _BatchClock:
    """Batch-end callback of Module.fit: the host time at the end of each
    batch (the metric has read the batch's outputs, so the card has
    finished it), the batch's bucket and the epoch's running metric."""

    def __init__(self):
        self.marks = []
        self.metric = {}

    def __call__(self, param):
        self.marks.append((param.epoch, time.perf_counter(),
                           param.locals["data_batch"].bucket_key))
        self.metric[param.epoch] = param.eval_metric.get()[1]


def _lm_sym_gen():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples.train_rnn_lm import sym_gen_factory

    return sym_gen_factory(mx, LM["layers"], LM["hidden"], LM["embed"],
                           LM["vocab"])


def _lm_corpus():
    from mxnet_tpu_torch.examples.train_rnn_lm import synthetic_corpus

    return synthetic_corpus(LM["vocab"], LM["sentences"], LM["buckets"],
                            seed=SEED)


def _lm_bucketing():
    """BucketingModule.fit over BucketSentenceIter, perplexity scored
    before and after; samples/s and tokens/s overall and per bucket."""
    import mxnet_tpu_torch as mx

    mx.random.seed(SEED)
    it = mx.rnn.BucketSentenceIter(_lm_corpus(), batch_size=LM["batch"],
                                   buckets=list(LM["buckets"]),
                                   invalid_label=0, seed=SEED,
                                   ctx=mx.gpu(0))
    mod = mx.mod.BucketingModule(_lm_sym_gen(),
                                 default_bucket_key=max(LM["buckets"]),
                                 context=mx.gpu(0))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(initializer=mx.init.Xavier())
    t0 = time.perf_counter()
    ppl0 = mod.score(it, mx.metric.Perplexity(ignore_label=0))[0][1]
    score_s = time.perf_counter() - t0
    it.reset()
    clock = _BatchClock()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=LM["epochs"],
            eval_metric=mx.metric.Perplexity(ignore_label=0),
            optimizer=LM["optimizer"],
            optimizer_params={"learning_rate": LM["lr"], "wd": LM["wd"]},
            batch_end_callback=clock)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    ppl1 = mod.score(it, mx.metric.Perplexity(ignore_label=0))[0][1]
    per_bucket = {}
    for (e0, t_0, _), (e1, t_1, key) in zip(clock.marks, clock.marks[1:]):
        if e0 == e1:
            per_bucket.setdefault(key, []).append(t_1 - t_0)
    batches = len(clock.marks)
    tokens = sum(LM["batch"] * key for _, _, key in clock.marks)
    reading = {
        "config": LM, "batches": batches, "fit_seconds": fit_s,
        "score_seconds": score_s,
        "samples_s": batches * LM["batch"] / fit_s,
        "tokens_s": tokens / fit_s,
        "per_bucket": {str(k): {
            "batches": len(v), "batch_ms_median": 1e3 * float(np.median(v)),
            "samples_s": LM["batch"] / float(np.median(v)),
            "tokens_s": LM["batch"] * k / float(np.median(v))}
            for k, v in sorted(per_bucket.items())},
        "train_perplexity_by_epoch": [clock.metric[e]
                                      for e in sorted(clock.metric)],
        "perplexity_before": ppl0, "perplexity_after": ppl1,
        "factor_limit": LM_PPL_FACTOR}
    log("phase 16: LM %d batches in %.1f s, %.1f samples/s, %.0f tokens/s; "
        "perplexity %.1f -> %.1f" % (batches, fit_s, reading["samples_s"],
                                     reading["tokens_s"], ppl0, ppl1))
    reading["profile_t60"] = _lm_profile(mod)
    arg, _ = mod.get_params()
    return reading, {n: a.asnumpy() for n, a in arg.items()}


def _lm_batch(mx, key, batch, ctx, seed, dtype="float32"):
    from mxnet_tpu_torch.io import DataBatch, DataDesc

    rng = np.random.default_rng(seed)
    data = rng.integers(1, LM["vocab"], (batch, key)).astype(np.float32)
    label = np.roll(data, -1, axis=1)
    label[:, -1] = 0
    return DataBatch(
        data=[mx.nd.array(data, ctx=ctx, dtype=dtype)],
        label=[mx.nd.array(label, ctx=ctx)], bucket_key=key,
        provide_data=[DataDesc("data", data.shape, np.dtype(dtype))],
        provide_label=[DataDesc("softmax_label", label.shape)])


def _lm_profile(mod, iters=5):
    """One b32 batch at T 60 (forward, backward, update): operator
    dispatches through the registry, CUDA kernel launches and device ms
    (torch.profiler), wall ms, idle share."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry

    batch = _lm_batch(mx, 60, LM["batch"], mx.gpu(0), SEED + 1)

    def step():
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()

    step()
    torch.cuda.synchronize()
    d0, t0 = registry.DISPATCHES[0], time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    dispatches = (registry.DISPATCHES[0] - d0) / iters
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    kernels, count = {}, 0
    for evt in prof.key_averages():
        if str(evt.device_type).endswith("CUDA"):
            kernels[evt.key] = kernels.get(evt.key, 0.0) + \
                evt.self_device_time_total
            count += evt.count
    device_ms = sum(kernels.values()) / 1e3 / iters
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    return {"batch": LM["batch"], "seq_len": 60, "wall_ms": wall,
            "dispatches_per_batch": dispatches,
            "launches_per_batch": count / iters,
            "device_ms": device_ms if kernels else None,
            "idle_share": 1 - device_ms / wall if kernels else None,
            "top_kernels": [[k[:80], v / 1e3 / iters] for k, v in top]}


def _lm_step(ctx, w0, dtype):
    """One SGD-momentum step of the LM at bucket 10, batch 8, from `w0`
    on `ctx` in `dtype`: (softmax outputs, weights, momentum)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.io import DataDesc

    sym, _, _ = _lm_sym_gen()(10)
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[DataDesc("data", (PARITY_BATCH, 10),
                                   np.dtype(dtype))],
             label_shapes=[DataDesc("softmax_label", (PARITY_BATCH, 10))])
    mod.init_params(arg_params={n: mx.nd.array(v, ctx=ctx)
                                for n, v in w0.items()}, aux_params={})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(TRAINER_OPT))
    mod.forward(_lm_batch(mx, 10, PARITY_BATCH, ctx, SEED + 2, dtype),
                is_train=True)
    out = mod.get_outputs()[0].asnumpy().astype(np.float64)
    mod.backward()
    mod.update()
    arg, _ = mod.get_params()
    mom = {mod._param_names[i]: s.asnumpy().astype(np.float64)
           for i, s in mod._updater.states.items()}
    return out, {n: a.asnumpy().astype(np.float64)
                 for n, a in arg.items()}, mom


def _lm_parity(w0):
    """The LM step on card and host, float64 and fp32, from the trained
    weights. SGD, not the training's adam: adam's first step is about
    lr * sign(gradient), so fp32 rounding flips whole steps wherever a
    gradient is near zero; SGD's momentum holds the gradient itself."""
    import mxnet_tpu_torch as mx

    lim = PARITY_LIMITS
    runs = {}
    for tag, ctx, dtype in (("card_f64", mx.gpu(0), "float64"),
                            ("host_f64", mx.cpu(), "float64"),
                            ("card_fp32", mx.gpu(0), "float32"),
                            ("host_fp32", mx.cpu(), "float32")):
        t0 = time.perf_counter()
        runs[tag] = _lm_step(ctx, w0, dtype)
        log("phase 16: LM parity step %s %.2f s"
            % (tag, time.perf_counter() - t0))
    ref, host = runs["card_f64"], runs["host_f64"]
    failed = []

    def hold(name, value, limit):
        if not value <= limit:
            failed.append("%s %g > %g" % (name, value, limit))

    w0 = {n: v.astype(np.float64) for n, v in w0.items()}
    out_err = float(np.abs(ref[0] - host[0]).max())
    mom = _rel_max(ref[2], host[2])
    weight_excess = max(
        float((np.abs(ref[1][n] - w) - lim["f64_weight_rtol"]
               * np.abs(w)).max()) / max(float(np.abs(w - w0[n]).max()),
                                         1e-30)
        for n, w in host[1].items())
    reading = {"batch": PARITY_BATCH, "bucket": 10,
               "card_f64_vs_host_f64": {
                   "output_abs_max": out_err,
                   "momentum_rel_max": max(mom.values()),
                   "weight_excess_over_step": weight_excess}}
    hold("f64 outputs", out_err, lim["f64_loss"])
    hold("f64 momentum", max(mom.values()), lim["f64_momentum"])
    hold("f64 weights", weight_excess, lim["f64_weight_step"])
    errs = {tag: _rel_max(runs[tag][2], ref[2])
            for tag in ("card_fp32", "host_fp32")}
    for tag in errs:
        reading[tag + "_vs_card_f64"] = {
            "momentum_rel_max_by_tensor": errs[tag],
            "momentum_rel_l2": _rel_l2(runs[tag][2], ref[2])}
    for n in errs["card_fp32"]:
        hold("fp32 update of %s over %g x host's" % (
            n, LM_PARITY["fp32_update_ratio"]),
            errs["card_fp32"][n] - LM_PARITY["fp32_update_ratio"]
            * errs["host_fp32"][n], LM_PARITY["fp32_update_floor"])
    hold("fp32 update over the net against host's",
         reading["card_fp32_vs_card_f64"]["momentum_rel_l2"]
         / reading["host_fp32_vs_card_f64"]["momentum_rel_l2"],
         LM_PARITY["fp32_update_l2_ratio"])
    reading["limits"] = {**{k: lim[k] for k in (
        "f64_loss", "f64_momentum", "f64_weight_rtol", "f64_weight_step")},
        **LM_PARITY}
    reading["failed"] = failed
    reading["within"] = not failed
    return reading


def _gluon_lm(steps=10, seq_len=35):
    """Embedding -> gluon.rnn.LSTM(200, 2 layers, dropout 0.2) -> Dense,
    hybridized, through gluon.Trainer on one fixed b32 T35 batch."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    mx.random.seed(SEED)
    ctx = mx.gpu(0)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Embedding(LM["vocab"], LM["embed"]),
            gluon.rnn.LSTM(LM["hidden"], num_layers=LM["layers"],
                           dropout=0.2),
            gluon.nn.Dense(LM["vocab"], flatten=False))
    net.initialize(mx.init.Xavier(), ctx=ctx)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), LM["optimizer"],
                            {"learning_rate": LM["lr"], "wd": LM["wd"]})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.default_rng(SEED + 3)
    tokens = rng.integers(1, LM["vocab"], (seq_len + 1, LM["batch"]))
    x = mx.nd.array(tokens[:-1].astype(np.float32), ctx=ctx)
    y = mx.nd.array(tokens[1:].astype(np.float32), ctx=ctx)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(LM["batch"])
        losses.append(float(loss.mean().asscalar()))
        times.append(time.perf_counter() - t0)
    step_s = float(np.median(times[2:]))
    return {"batch": LM["batch"], "seq_len": seq_len, "steps": steps,
            "losses": losses, "step_ms_median": step_s * 1e3,
            "tokens_s": LM["batch"] * seq_len / step_s}


def _close_reading(got, want, atol_rel=None):
    got = got.astype(np.float64)
    want = want.astype(np.float64)
    atol = RNN_TOL["atol"] if atol_rel is None else \
        atol_rel * float(np.abs(want).max())
    return max_violation(torch.from_numpy(got), torch.from_numpy(want),
                         RNN_TOL["rtol"], atol)


def _foreach_vs_lstm(seq_len=35):
    """nd.contrib.foreach over a gluon LSTMCell(200) at T35 b32 against a
    one-layer gluon LSTM with the same weights: outputs and weight
    gradients (max violation of RNN_TOL; <= 0 is within)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon

    ctx, h = mx.gpu(0), LM["hidden"]
    rng = np.random.default_rng(SEED + 4)
    x = mx.nd.array(rng.standard_normal((seq_len, LM["batch"], h),
                                        dtype=np.float32), ctx=ctx)
    head = mx.nd.array(rng.standard_normal((seq_len, LM["batch"], h),
                                           dtype=np.float32), ctx=ctx)
    cell = gluon.rnn.LSTMCell(h, input_size=h)
    layer = gluon.rnn.LSTM(h, input_size=h)
    cell.initialize(mx.init.Xavier(), ctx=ctx)
    layer.initialize(ctx=ctx)
    for name in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        value = rng.standard_normal(getattr(cell, name).shape,
                                    dtype=np.float32) * 0.1
        getattr(cell, name).set_data(mx.nd.array(value, ctx=ctx))
        getattr(layer, "l0_" + name).set_data(mx.nd.array(value, ctx=ctx))
    states = cell.begin_state(LM["batch"], ctx=ctx)
    with autograd.record():
        outs, _ = mx.nd.contrib.foreach(lambda xt, s: cell(xt, s), x, states)
        (outs * head).sum().backward()
    with autograd.record():
        want = layer(x)
        (want * head).sum().backward()
    reading = {"seq_len": seq_len, "batch": LM["batch"],
               "output_violation": _close_reading(outs.asnumpy(),
                                                  want.asnumpy())}
    for name in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        reading[name + "_grad_violation"] = _close_reading(
            getattr(cell, name).grad().asnumpy(),
            getattr(layer, "l0_" + name).grad().asnumpy(),
            RNN_TOL["grad_atol_rel"])
    reading["within"] = all(v <= 0 for k, v in reading.items()
                            if k.endswith("violation"))
    return reading


def _control_flow_graphs(mx, h=200):
    """A while_loop (s <- tanh(dot(s, w)) while the counter is below 8,
    at most 10 steps) and a cond (dot(a, w) or 2a by the sign of sum(a)),
    grouped."""
    i, s, w, a = (mx.sym.var(n) for n in ("i", "s", "w", "a"))
    outs, finals = mx.sym.contrib.while_loop(
        lambda i_, s_: i_ < 8,
        lambda i_, s_: (s_, [i_ + 1, mx.sym.tanh(mx.sym.dot(s_, w))]),
        [i, s], max_iterations=10)
    branch = mx.sym.contrib.cond(lambda: mx.sym.sum(a) > 0,
                                 lambda: mx.sym.dot(a, w), lambda: a * 2)
    return mx.sym.Group([outs] + finals + [branch])


def _control_flow_card_vs_host(h=200):
    import mxnet_tpu_torch as mx

    rng = np.random.default_rng(SEED + 5)
    values = {"i": np.zeros((1,), np.float32),
              "s": rng.standard_normal((4, h), dtype=np.float32),
              "w": rng.standard_normal((h, h), dtype=np.float32) * 0.1,
              "a": np.abs(rng.standard_normal((4, h), dtype=np.float32))}
    res = {}
    for tag, ctx in (("host", mx.cpu()), ("card", mx.gpu(0))):
        sym = _control_flow_graphs(mx, h)
        ex = sym.bind(ctx, {n: mx.nd.array(v, ctx=ctx)
                            for n, v in values.items()},
                      args_grad={"w": mx.nd.zeros((h, h), ctx=ctx)},
                      grad_req={"i": "null", "s": "null", "w": "write",
                                "a": "null"})
        outs = ex.forward(is_train=True)
        ex.backward(out_grads=[mx.nd.ones(o.shape, ctx=ctx) for o in outs])
        res[tag] = [o.asnumpy() for o in outs] + \
            [ex.grad_dict["w"].asnumpy()]
    reading = {"shapes": [list(o.shape) for o in res["card"]],
               "violations": [_close_reading(c, hst) for c, hst in
                              zip(res["card"][:-1], res["host"][:-1])],
               "w_grad_violation": _close_reading(
                   res["card"][-1], res["host"][-1],
                   RNN_TOL["grad_atol_rel"])}
    reading["while_loop_rows_valid"] = int((np.abs(res["card"][0]).sum(
        axis=(1, 2)) > 0).sum())
    reading["within"] = all(v <= 0 for v in reading["violations"]) \
        and reading["w_grad_violation"] <= 0 \
        and reading["shapes"][0] == [10, 4, h] \
        and reading["while_loop_rows_valid"] == 8
    return reading


def _rnn_op_vs_cudnn(seq_len):
    """The port's RNN op (2 LSTM layers, 200 -> 200, N 32) forward and
    forward + backward, beside torch.nn.LSTM (cuDNN) with the same
    weights, whose outputs are held to the op's."""
    from mxnet_tpu_torch.ops import registry, rnn_ops

    h, n, layers = LM["hidden"], LM["batch"], LM["layers"]
    rng = np.random.default_rng(SEED + 6)
    size = rnn_ops.rnn_param_size(layers, h, h, "lstm")
    flat = torch.from_numpy(rng.uniform(-0.07, 0.07, size).astype(
        np.float32)).cuda().requires_grad_(True)
    x = torch.from_numpy(rng.standard_normal((seq_len, n, h), dtype=
                                             np.float32)).cuda()
    x.requires_grad_(True)
    h0, c0 = x.new_zeros(layers, n, h), x.new_zeros(layers, n, h)
    rnn = registry.get("RNN").fn
    attrs = {"state_size": h, "num_layers": layers, "mode": "lstm",
             "state_outputs": True}

    def port_fwd():
        with torch.no_grad():
            return rnn(x, flat, h0, c0, **attrs)

    def port_fwd_bwd():
        out = rnn(x, flat, h0, c0, **attrs)[0]
        out.sum().backward()

    lstm = torch.nn.LSTM(h, h, num_layers=layers).cuda()
    with torch.no_grad():
        for name, shape, off in rnn_ops.rnn_param_layout(layers, h, h,
                                                         "lstm"):
            # l<k>_i2h_weight -> weight_ih_l<k>, l<k>_h2h_bias -> bias_hh_l<k>
            part, what = name[3:].split("_")
            param = getattr(lstm, "%s_%s_l%s" % (what, part.replace("2", ""),
                                                 name[1]))
            param.copy_(flat[off:off + param.numel()].view(param.shape))
    lstm.flatten_parameters()

    def cudnn_fwd():
        with torch.no_grad():
            return lstm(x, (h0, c0))

    def cudnn_fwd_bwd():
        out = lstm(x, (h0, c0))[0]
        out.sum().backward()

    got = port_fwd()
    want_out, (want_h, want_c) = cudnn_fwd()
    violation = max(max_violation(g, w, RNN_TOL["rtol"], RNN_TOL["atol"])
                    for g, w in zip(got, (want_out, want_h, want_c)))
    return {"seq_len": seq_len, "batch": n, "hidden": h, "layers": layers,
            "port_fwd_ms": time_ms(port_fwd, iters=10),
            "port_fwd_bwd_ms": time_ms(port_fwd_bwd, iters=10),
            "cudnn_fwd_ms": time_ms(cudnn_fwd, iters=10),
            "cudnn_fwd_bwd_ms": time_ms(cudnn_fwd_bwd, iters=10),
            "cudnn_vs_op_violation": violation}


def phase_recurrent(card_line):
    """Phase 16: the recurrent path at full width (see the module
    docstring)."""
    from mxnet_tpu_torch.ops import control_flow

    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    t_phase = time.perf_counter()
    result = {"phase": "recurrent", "card": card_line}
    _reset_all_launches()   # the main path starts here
    reads0 = control_flow.PREDICATE_READS[0]
    result["lm"], weights = _lm_bucketing()
    result["lm_parity"] = _lm_parity(weights)
    result["gluon_lm"] = _gluon_lm()
    result["foreach_vs_lstm"] = _foreach_vs_lstm()
    result["control_flow_card_vs_host"] = _control_flow_card_vs_host()
    result["rnn_op"] = [_rnn_op_vs_cudnn(t) for t in (35, 60)]
    launches = _all_launches()   # read just after the path
    result["predicate_reads"] = control_flow.PREDICATE_READS[0] - reads0
    result["launches"] = launches
    result["seconds"] = time.perf_counter() - t_phase
    log(json.dumps(result))
    lm = result["lm"]
    check(lm["perplexity_after"] * LM_PPL_FACTOR <= lm["perplexity_before"],
          "LM perplexity fell from %.1f to %.1f, not by %gx"
          % (lm["perplexity_before"], lm["perplexity_after"],
             LM_PPL_FACTOR))
    check(result["lm_parity"]["within"], "LM step card vs host: %s"
          % result["lm_parity"]["failed"])
    g = result["gluon_lm"]["losses"]
    check(g[-1] < g[0], "gluon LSTM LM loss did not fall: %s" % g)
    check(result["foreach_vs_lstm"]["within"], "foreach over LSTMCell vs "
          "LSTM: %s" % result["foreach_vs_lstm"])
    check(result["control_flow_card_vs_host"]["within"], "control flow "
          "card vs host: %s" % result["control_flow_card_vs_host"])
    for r in result["rnn_op"]:
        check(r["cudnn_vs_op_violation"] <= 0, "cuDNN LSTM vs the RNN op "
              "at T %d: %g" % (r["seq_len"], r["cudnn_vs_op_violation"]))
    return result


# -- phase 17: the core surface -----------------------------------------------

# The operator names of mxnet_tpu/ops/{elementwise,matrix,reduce,nn,
# random_ops}.py that the core surface's first half registers in the port
# (130 operators; "identity" gains two aliases).
CORE_SURFACE_NAMES = (
    "BilinearSampler", "BlockGrad", "Deconvolution", "GridGenerator",
    "InstanceNorm", "L2Normalization", "LRN", "LayerNorm", "LeakyReLU",
    "LinearRegressionOutput", "LogisticRegressionOutput",
    "MAERegressionOutput", "MakeLoss", "Pad", "SoftmaxActivation",
    "SpatialTransformer", "SwapAxis", "UpSampling", "_arange", "_arctan2",
    "_copy", "_full", "_hypot", "_index", "_logical_and", "_logical_or",
    "_logical_xor", "_maximum", "_maximum_scalar", "_minimum",
    "_minimum_scalar", "_mod", "_mod_scalar", "_ones", "_random_exponential",
    "_random_gamma", "_random_generalized_negative_binomial",
    "_random_negative_binomial", "_random_normal", "_random_poisson",
    "_random_randint", "_random_uniform", "_rmod_scalar", "_rpower_scalar",
    "_sample_exponential", "_sample_gamma", "_sample_multinomial",
    "_sample_normal", "_sample_poisson", "_sample_uniform",
    "_sample_unique_zipfian", "_scatter_nd_add", "_scatter_set_nd",
    "_shuffle", "_zeros", "arange", "arccos", "arccosh", "arcsin", "arcsinh",
    "arctan", "arctan2", "arctanh", "argmax", "argmax_channel", "argmin",
    "argsort", "batch_dot", "batch_take", "bilinear_sampler",
    "broadcast_hypot", "broadcast_like", "broadcast_logical_and",
    "broadcast_logical_or", "broadcast_logical_xor", "broadcast_maximum",
    "broadcast_minimum", "broadcast_mod", "broadcast_to", "cbrt", "ceil",
    "cos", "cosh", "crop", "cumsum", "deconvolution", "degrees",
    "depth_to_space", "diag", "erf", "erfinv", "expm1", "fix", "flip",
    "floor", "full", "gamma", "gammaln", "gather_nd", "grid_generator",
    "histogram", "identity_with_attr_like_rhs", "instance_norm", "isinf",
    "isnan", "l2_normalization", "layer_norm", "leaky_relu",
    "linear_regression_output", "log10", "log1p", "log2", "logical_not",
    "logistic_regression_output", "lrn", "mae_regression_output", "make_loss",
    "make_loss_grad_block", "max", "maximum", "min", "minimum", "moveaxis",
    "multinomial", "nanprod", "nansum", "normal", "normal_like", "one_hot",
    "ones", "pad", "prod", "radians", "randint", "random_exponential",
    "random_gamma", "random_generalized_negative_binomial",
    "random_negative_binomial", "random_normal", "random_poisson",
    "random_randint", "random_uniform", "ravel_multi_index", "rcbrt",
    "reciprocal", "repeat", "reshape_like", "reverse", "rint", "round",
    "rsqrt", "sample_exponential", "sample_gamma", "sample_multinomial",
    "sample_normal", "sample_poisson", "sample_uniform", "scatter_nd",
    "shape_array", "shuffle", "sin", "sinh", "size_array", "slice",
    "slice_like", "smooth_l1", "softmax_activation", "softmax_cross_entropy",
    "softmin", "softsign", "sort", "space_to_depth", "spatial_transformer",
    "squeeze", "stop_gradient", "sum_axis", "sum_mid_internal", "swapaxes",
    "tan", "tile", "topk", "trunc", "uniform", "unravel_index", "upsampling",
    "zeros",
)

# Model widths the sweep runs at: ResNet-50's stage-1 activation, the
# ImageNet logits, the LM's 32 x 60 tokens over a 10 000-word vocabulary,
# a Gram product, the LM's and BERT-base's LayerNorm inputs, an FCN's
# 21-class score map, STN input images.
SURFACE = {"act": (32, 256, 56, 56), "logits": (32, 1000),
           "lm": (32 * 60, 10000), "tokens": (32, 60), "gram": (1, 512, 4096),
           "ln_lm": (32, 35, 200), "ln_bert": (32, 128, 768),
           "score": (32, 21, 7, 7), "image": (32, 3, 224, 224),
           "lrn": (32, 96, 55, 55), "draws": 1_000_000}

# (rtol, atol as a share of max |want|) per family: the card in fp32
# against the host in float64 (forward and gradients). "exact" ops (data
# movement, orderings, creation, indices) are held bit for bit.
SURFACE_TOL = {"elementwise": (1e-5, 1e-6), "reduce": (1e-4, 1e-5),
               "ordering": (0.0, 0.0), "matrix": (0.0, 0.0),
               "linalg": (1e-4, 1e-5), "nn": (1e-4, 1e-5),
               "resampling": (1e-4, 1e-4)}
SURFACE_GRAD_TOL = (1e-4, 1e-5)
# gelqf and syevd are held on the card to their backward errors, the
# ratio LAPACK's test drivers take: a residual's Frobenius norm over n
# eps times the norm of what it should equal (reconstruction: A - L Q,
# A - U^T diag(w) U over ||A||; orthogonality: Q Q^T - I, U U^T - I over
# ||I||), per matrix, n the number of rows of Q (the reflections), eps =
# 2^-23, float32's spacing at 1. A backward-stable float32 factorization
# reads at most about 1 (its errors grow as n eps in practice; the
# worst-case bounds grow faster and are never reached). Factors that
# carry TF32's 10 mantissa bits read about u / (n eps) = 2^-11 / (256 x
# 2^-23) = 16 at n = 256, from their rounding alone. The limit is the
# geometric mean of the two, a factor of 4 of room either side; the
# card's factors rounded to TF32 and to bf16 must read above it.
FACTOR_EPS = 2.0 ** -23
FACTOR_RESIDUAL_LIMIT = 4.0
# The factorizations' readings of this process, by op: each residual's
# worst ratio over the batch, and the rounded controls'.
FACTOR_READINGS = {}


class _Case:
    """One run of an operator in the sweep: `make(gen, dev)` gives
    (input tensors, attrs); `grad` is None (forward only), "head" (a
    random head gradient), "compose" (the gradient of op(x) * x),
    "loss" (a head of ones); `wrt` the inputs differentiated; `rows`
    True where the op acts on rows independently, so that the host
    computes only the rows of `_host_rows` (None: all rows);
    `host_dtype` the host's float dtype."""

    def __init__(self, op, family, make, grad="head", wrt=None, rows=True,
                 host_dtype=torch.float64, invariant=None):
        self.op, self.family, self.make = op, family, make
        self.grad, self.wrt, self.rows = grad, wrt, rows
        self.host_dtype = host_dtype
        # For an output unique only up to signs (gelqf, syevd): a
        # function (op, card outputs, host outputs, card inputs, rows)
        # -> worst share of its limit, used in place of the
        # output-by-output comparison.
        self.invariant = invariant


def _host_rows(batch):
    """The rows of a batch the host recomputes: the first, the last and
    one between them drawn from the seed, so that a fault that depends
    on the row index shows."""
    middle = np.random.default_rng(SEED + batch).integers(1, batch - 1) \
        if batch > 2 else 0
    return sorted({0, int(middle), batch - 1})


def _rand(gen, dev, shape, lo=-1.0, hi=1.0):
    return torch.empty(shape, device=dev).uniform_(lo, hi, generator=gen)


def _away(gen, dev, shape, scale=1.0):
    """Uniform in [-scale, scale] at least 0.15 scale from 0."""
    x = _rand(gen, dev, shape)
    return torch.where(x.abs() < 0.15, x + 0.3, x) * scale


def _mod_pair(gen, dev, shape, b=None):
    """(a, b) with a / b at least 0.05 from an integer, so fp32's floor
    of a / b agrees with float64's: a = (k + f) b."""
    if b is None:
        b = _rand(gen, dev, shape, 0.5, 2.0)
    k = torch.randint(-5, 5, shape, generator=gen, device=dev).float()
    return (k + _rand(gen, dev, shape, 0.05, 0.95)) * b, b


def _with_nan(gen, dev, shape, lo=-1.0, hi=1.0):
    x = _rand(gen, dev, shape, lo, hi)
    return torch.where(_rand(gen, dev, shape, 0, 1) < 0.05,
                       torch.full_like(x, float("nan")), x)


def _idx(gen, dev, n, high):
    return torch.randint(0, high, (n,), generator=gen, device=dev).float()


def _surface_cases():
    """Every deterministic operator of CORE_SURFACE_NAMES at a model's
    width; orderings and one_hot at two widths."""
    S = SURFACE
    act, lm, logits = S["act"], S["lm"], S["logits"]
    pooled = act[:2] + (1, 1)
    cases = []

    def add(op, family, make, **kw):
        cases.append(_Case(op, family, make, **kw))

    def unary(op, lo=-1.0, hi=1.0, **kw):
        add(op, "elementwise",
            lambda g, d: ([_rand(g, d, act, lo, hi)], {}), **kw)

    for op in ("identity", "expm1", "sin", "cos", "arctan", "degrees",
               "radians", "sinh", "arcsinh", "erf", "softsign"):
        unary(op)
    unary("cosh", -3.0, 3.0)
    unary("tan", -1.2, 1.2)
    for op in ("reciprocal", "rsqrt", "log10", "log2", "log1p"):
        unary(op, 0.2, 4.0)
    for op in ("arcsin", "arccos", "arctanh"):
        unary(op, -0.9, 0.9)
    unary("erfinv", -0.95, 0.95)
    unary("arccosh", 1.1, 4.0)
    for op in ("gamma", "gammaln"):
        unary(op, 0.2, 6.0)
    for op in ("cbrt", "rcbrt"):
        add(op, "elementwise", lambda g, d: ([_away(g, d, act, 3.0)], {}))
    add("smooth_l1", "elementwise",
        lambda g, d: ([_away(g, d, act, 2.0)], {"scalar": 1.0}))
    for op in ("round", "rint", "ceil", "floor", "trunc", "fix"):
        unary(op, -4.0, 4.0, grad=None)
    add("logical_not", "elementwise",
        lambda g, d: ([torch.round(_rand(g, d, act))], {}), grad=None)
    for op in ("isnan", "isinf"):
        add(op, "elementwise", lambda g, d: ([torch.where(
            _rand(g, d, act, 0, 1) < 0.05, torch.tensor(
                [float("nan"), float("inf")], device=d)[
                torch.randint(0, 2, act, generator=g, device=d)],
            _rand(g, d, act))], {}), grad=None)
    add("stop_gradient", "elementwise",
        lambda g, d: ([_rand(g, d, act)], {}), grad="compose")
    # Binary: a channel-broadcast operand (its gradient sums over the
    # batch: the host takes every row), then full operands.
    for op in ("broadcast_maximum", "broadcast_hypot"):
        add(op, "elementwise", lambda g, d: (
            [_away(g, d, act), _away(g, d, pooled) + 0.05], {}), rows=None)
    for op in ("broadcast_minimum", "arctan2"):
        add(op, "elementwise", lambda g, d: (
            [_away(g, d, act), _away(g, d, act) + 0.05], {}))
    add("broadcast_mod", "elementwise",
        lambda g, d: (list(_mod_pair(g, d, act)), {}))
    for op in ("broadcast_logical_and", "broadcast_logical_or",
               "broadcast_logical_xor"):
        add(op, "elementwise", lambda g, d: (
            [torch.round(_rand(g, d, act)), torch.round(_rand(g, d, act))],
            {}), grad=None)
    for op in ("_maximum_scalar", "_minimum_scalar"):
        add(op, "elementwise",
            lambda g, d: ([_away(g, d, act)], {"scalar": 0.0}))
    add("_mod_scalar", "elementwise", lambda g, d: (
        [_mod_pair(g, d, act, torch.full(act, 1.7, device=d))[0]],
        {"scalar": 1.7}))
    add("_rmod_scalar", "elementwise", lambda g, d: (
        [2.3 / (torch.randint(1, 4, act, generator=g, device=d).float()
                + _rand(g, d, act, 0.05, 0.95))], {"scalar": 2.3}))
    add("_rpower_scalar", "elementwise",
        lambda g, d: ([_rand(g, d, act, -3, 3)], {"scalar": 1.7}))

    # Reductions over the spatial axes (rows independent).
    for op in ("max", "min"):
        add(op, "reduce", lambda g, d: ([_rand(g, d, act)],
                                        {"axis": (2, 3)}))
    add("prod", "reduce",
        lambda g, d: ([_rand(g, d, act, 0.99, 1.01)], {"axis": (2, 3)}))
    add("nansum", "reduce",
        lambda g, d: ([_with_nan(g, d, act)], {"axis": (2, 3)}))
    add("nanprod", "reduce", lambda g, d: (
        [_with_nan(g, d, act, 0.99, 1.01)], {"axis": (2, 3)}))
    add("sum_axis", "reduce",
        lambda g, d: ([_rand(g, d, act)], {"axis": 1}))
    add("cumsum", "reduce", lambda g, d: ([_rand(g, d, act)], {"axis": 3}))
    add("_scatter_nd_add", "reduce", lambda g, d: (
        [_rand(g, d, (2 * lm[0],)),
         torch.stack([_idx(g, d, 2 * lm[0], lm[0]),
                      _idx(g, d, 2 * lm[0], lm[1])])],
        {"shape": lm}), wrt=(0,), rows=None)

    # Orderings, exact, at the logits' and the LM's widths.
    for shape in (logits, lm):
        for op in ("argmax", "argmin"):
            add(op, "ordering", lambda g, d, s=shape: (
                [_rand(g, d, s)], {"axis": 1}), grad=None)
        add("sort", "ordering",
            lambda g, d, s=shape: ([_rand(g, d, s)], {"axis": 1,
                                                      "is_ascend": False}))
        add("argsort", "ordering",
            lambda g, d, s=shape: ([_rand(g, d, s)], {"axis": 1}), grad=None)
        add("topk", "ordering", lambda g, d, s=shape: (
            [_rand(g, d, s)], {"axis": 1, "k": 5, "ret_typ": "both"}),
            grad=None)
        add("one_hot", "matrix", lambda g, d, s=shape: (
            [_idx(g, d, s[0], s[1])], {"depth": s[1]}), grad=None)
    add("argmax_channel", "ordering",
        lambda g, d: ([_rand(g, d, logits)], {}), grad=None)
    add("histogram", "ordering", lambda g, d: (
        [torch.randn(act, generator=g, device=d)],
        {"bin_cnt": 20, "range": (-3.0, 3.0)}), grad=None, rows=None,
        host_dtype=torch.float32)

    # Shape, indexing and creation: exact.
    def shaped(op, attrs, **kw):
        add(op, "matrix", lambda g, d: ([_rand(g, d, act)], dict(attrs)),
            **kw)

    shaped("_index", {"key": (slice(None), slice(0, 128),
                              slice(None, None, 2))})
    shaped("slice", {"begin": (None, 0, 4, None), "end": (None, 128, 52,
                                                          None),
                     "step": (None, 2, 1, -1)})
    shaped("tile", {"reps": (1, 1, 2, 1)})
    shaped("repeat", {"repeats": 2, "axis": 3})
    for mode in ("constant", "edge", "reflect"):
        shaped("pad", {"mode": mode, "pad_width": (0, 0, 0, 0, 1, 1, 1, 1),
                       "constant_value": 0.5})
    shaped("flip", {"axis": 3})
    shaped("swapaxes", {"dim1": 1, "dim2": 3})
    shaped("moveaxis", {"source": 1, "destination": 3})
    shaped("depth_to_space", {"block_size": 2})
    shaped("space_to_depth", {"block_size": 2})
    shaped("shape_array", {}, grad=None, rows=None,
           host_dtype=torch.float32)
    shaped("size_array", {}, grad=None, rows=None, host_dtype=torch.float32)
    add("slice_like", "matrix", lambda g, d: (
        [_rand(g, d, act), _rand(g, d, act[:2] + (act[2] // 2,) * 2)], {}),
        wrt=(0,))
    add("reshape_like", "matrix", lambda g, d: (
        [_rand(g, d, act), _rand(g, d, (act[0], act[1] * act[2] * act[3]))],
        {}), wrt=(0,))
    add("squeeze", "matrix",
        lambda g, d: ([_rand(g, d, pooled)], {"axis": (2, 3)}))
    add("broadcast_to", "matrix",
        lambda g, d: ([_rand(g, d, pooled)], {"shape": (0,) + act[1:]}))
    add("broadcast_like", "matrix", lambda g, d: (
        [_rand(g, d, pooled), _rand(g, d, act)], {}), wrt=(0,))
    add("batch_take", "matrix", lambda g, d: (
        [_rand(g, d, lm), _idx(g, d, lm[0], lm[1])], {}), wrt=(0,))
    rows_cols = (lambda g, d: torch.stack([
        torch.arange(lm[0], device=d).float(), _idx(g, d, lm[0], lm[1])]))
    add("gather_nd", "matrix", lambda g, d: (
        [_rand(g, d, lm), rows_cols(g, d)], {}), wrt=(0,), rows=None)
    add("scatter_nd", "matrix", lambda g, d: (
        [_rand(g, d, (lm[0],)), rows_cols(g, d)], {"shape": lm}), wrt=(0,),
        rows=None)
    add("_scatter_set_nd", "matrix", lambda g, d: (
        [_rand(g, d, lm), rows_cols(g, d).long()], {"value": 0.5}),
        grad=None, rows=None)
    add("ravel_multi_index", "matrix", lambda g, d: (
        [rows_cols(g, d)], {"shape": lm}), grad=None, rows=None)
    add("unravel_index", "matrix", lambda g, d: (
        [_idx(g, d, lm[0], lm[0] * lm[1])], {"shape": lm}), grad=None,
        rows=None)
    add("diag", "matrix", lambda g, d: ([_rand(g, d, S["gram"][1:2] * 2)],
                                        {}), rows=None)
    add("arange", "matrix", lambda g, d: (
        [], {"start": 0.0, "stop": float(lm[1]), "step": 1.0}), grad=None,
        rows=None)
    add("zeros", "matrix", lambda g, d: ([], {"shape": act}), grad=None,
        rows=None)
    add("ones", "matrix", lambda g, d: ([], {"shape": act}), grad=None,
        rows=None)
    add("full", "matrix", lambda g, d: ([], {"shape": act, "value": 2.5}),
        grad=None, rows=None)

    add("batch_dot", "linalg", lambda g, d: (
        [_rand(g, d, S["gram"]), _rand(g, d, S["gram"])],
        {"transpose_b": True}), rows=None)

    # Normalization, activations, losses.
    for shape in (S["ln_lm"], S["ln_bert"]):
        add("LayerNorm", "nn", lambda g, d, s=shape: (
            [_rand(g, d, s), _rand(g, d, s[-1:], 0.5, 1.5),
             _rand(g, d, s[-1:])], {}), rows=None)
    add("InstanceNorm", "nn", lambda g, d: (
        [_rand(g, d, act), _rand(g, d, act[1:2], 0.5, 1.5),
         _rand(g, d, act[1:2])], {"eps": 1e-5}), rows=None)
    add("L2Normalization", "nn",
        lambda g, d: ([_rand(g, d, act)], {"mode": "instance"}))
    add("LRN", "nn", lambda g, d: ([_rand(g, d, S["lrn"], 0, 1)],
                                   {"nsize": 5}))
    for act_type in ("leaky", "elu", "selu", "gelu", "rrelu"):
        add("LeakyReLU", "nn", lambda g, d, t=act_type: (
            [_away(g, d, act, 3.0)], {"act_type": t, "slope": 0.2}))
    add("LeakyReLU", "nn", lambda g, d: (
        [_away(g, d, act, 3.0), _rand(g, d, act[1:2], 0, 0.5)],
        {"act_type": "prelu"}), wrt=(0,))
    add("SoftmaxActivation", "nn",
        lambda g, d: ([_rand(g, d, logits, -5, 5)], {}), rows=None)
    add("SoftmaxActivation", "nn",
        lambda g, d: ([_rand(g, d, act, -5, 5)], {"mode": "channel"}))
    add("softmin", "nn", lambda g, d: ([_rand(g, d, logits, -5, 5)], {}),
        rows=None)
    add("softmax_cross_entropy", "nn", lambda g, d: (
        [_rand(g, d, logits, -5, 5), _idx(g, d, logits[0], logits[1])], {}),
        wrt=(0,), rows=None)
    for op in ("LinearRegressionOutput", "LogisticRegressionOutput",
               "MAERegressionOutput"):
        add(op, "nn", lambda g, d: (
            [_rand(g, d, logits), _rand(g, d, logits, 0, 1)],
            {"grad_scale": 0.5}), wrt=(0,), rows=None)
    add("make_loss", "nn", lambda g, d: (
        [_rand(g, d, (logits[0],), 0, 2)],
        {"grad_scale": 0.5, "normalization": "valid", "valid_thresh": 0.5}),
        grad="loss", rows=None)

    # Resampling: an FCN's 21-class scores upsampled x2 and x32, STN
    # sampling of 224 x 224 images.
    score = S["score"]
    for k, stride, pad in ((4, 2, 1), (64, 32, 16)):
        add("Deconvolution", "resampling", lambda g, d, k=k, st=stride,
            p=pad: ([_rand(g, d, score), _rand(g, d, (score[1], 1, k, k))],
                    {"kernel": (k, k), "stride": (st, st), "pad": (p, p),
                     "num_filter": score[1], "num_group": score[1],
                     "no_bias": True}), rows=None)
    for scale in (2, 32):
        add("UpSampling", "resampling", lambda g, d, sc=scale: (
            [_rand(g, d, score)], {"scale": sc, "sample_type": "nearest"}))
    add("UpSampling", "resampling", lambda g, d: (
        [_rand(g, d, score)], {"scale": 2, "sample_type": "bilinear"}))
    image = S["image"]

    def theta(g, d):
        eye = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], device=d)
        return eye + 0.1 * _rand(g, d, (image[0], 6))

    add("GridGenerator", "resampling", lambda g, d: (
        [theta(g, d)], {"transform_type": "affine",
                        "target_shape": image[2:]}), rows=None)
    def grid(g, d):
        """Sampling points k + f pixels from the corner, f in [0.05,
        0.95], some beyond the edges: the gradient to the grid jumps
        where a point crosses a pixel, so none lies within rounding of
        one."""
        shape = (image[0], 2) + image[2:]
        side = torch.tensor([image[3], image[2]], device=d).view(1, 2, 1, 1)
        k = torch.floor(_rand(g, d, shape, 0.0, 1.0) * (side + 3)) - 2
        pix = k + _rand(g, d, shape, 0.05, 0.95)
        return 2 * pix / (side - 1) - 1

    add("BilinearSampler", "resampling", lambda g, d: (
        [_rand(g, d, image), grid(g, d)], {}))
    # The gradient to `loc` sums that jumping gradient over every
    # sampled pixel: held through BilinearSampler's grid above instead.
    add("SpatialTransformer", "resampling", lambda g, d: (
        [_rand(g, d, image), theta(g, d)],
        {"target_shape": image[2:]}), wrt=(0,))
    return cases


# The rest of the registry: the linalg half of
# mxnet_tpu/ops/sequence.py (13 operators, each under two names, and
# khatri_rao) and the contrib tail of contrib_ops.py (6 operators, two
# names each). Each name is swept once, at these model widths: 32
# matrices of 256 (an SPD batch B B^T / n + I, a Gaussian process's
# covariance or a whitening layer's), an LQ of 256 x 512, 16 x 16 for
# det (whose value overflows fp32 at 256), the Khatri-Rao product of a
# 64- and a 128-row factor of rank 512, ResNet-50's stage-1 activation
# pooled to 7 x 7, STN images resized to Inception's 299, FFTs of 4096
# points, 1024 rows copied into the LM's 10 000 x 200 embedding, and a
# count sketch of 4096 features into 1024 buckets.
TAIL_SURFACE_NAMES = (
    "_contrib_AdaptiveAvgPooling2D", "_contrib_BilinearResize2D",
    "_contrib_CountSketch", "_contrib_FFT", "_contrib_IFFT",
    "_contrib_IndexCopy", "_contrib_adaptive_avg_pooling2d",
    "_contrib_bilinear_resize2d", "_contrib_count_sketch", "_contrib_fft",
    "_contrib_ifft", "_contrib_index_copy", "_linalg_det", "_linalg_gelqf",
    "_linalg_gemm", "_linalg_gemm2", "_linalg_inverse", "_linalg_potrf",
    "_linalg_potri", "_linalg_slogdet", "_linalg_sumlogdiag",
    "_linalg_syevd", "_linalg_syrk", "_linalg_trmm", "_linalg_trsm",
    "khatri_rao", "linalg_det", "linalg_gelqf", "linalg_gemm",
    "linalg_gemm2", "linalg_inverse", "linalg_potrf", "linalg_potri",
    "linalg_slogdet", "linalg_sumlogdiag", "linalg_syevd", "linalg_syrk",
    "linalg_trmm", "linalg_trsm",
)

TAIL = {"spd": (32, 256, 256), "lq": (32, 256, 512), "det": (32, 16, 16),
        "kr": ((64, 512), (128, 512)), "rhs": 64, "pool": 7,
        "resize": 299, "fft": (32, 4096), "embed": (10000, 200),
        "copy_rows": 1024, "sketch": (32, 4096, 1024)}


def _spd(gen, dev, shape):
    """B B^T / n + I, exactly symmetric: eigenvalues in [1, ~2.3]."""
    b = _rand(gen, dev, shape)
    a = b @ b.transpose(-1, -2) / shape[-1]
    return (a + a.transpose(-1, -2)) / 2 + torch.eye(shape[-1], device=dev)


def _eye_like(x):
    return torch.eye(x.shape[-1], dtype=x.dtype,
                     device=x.device).expand(x.shape)


def _backward_error(got, want, n):
    """Worst over the batch of ||got - want||_F / (n eps ||want||_F)."""
    diff = torch.linalg.matrix_norm(got - want)
    return float((diff / (n * FACTOR_EPS
                          * torch.linalg.matrix_norm(want))).max())


def _round_bits(x, bits):
    """`x` rounded to nearest at `bits` mantissa bits (TF32: 10)."""
    m, e = torch.frexp(x)
    return torch.ldexp(torch.round(m * 2.0 ** (bits + 1))
                       / 2.0 ** (bits + 1), e)


def _factor_residuals(op, factors, residuals, n):
    """The worst of `residuals(*factors)` ((got, want) pairs by name) as
    a share of FACTOR_RESIDUAL_LIMIT at order `n`; the readings, and
    those of the factors rounded to TF32 and to bf16 (whose worst must
    exceed the limit), go to FACTOR_READINGS[op]."""
    def read(fs):
        return {name: _backward_error(got, want, n) for name, (got, want)
                in residuals(*[f.double() for f in fs]).items()}

    got = read(factors)
    reading = FACTOR_READINGS[op] = dict(
        got, limit=FACTOR_RESIDUAL_LIMIT,
        tf32_rounded=read([_round_bits(f, 10) for f in factors]),
        bf16_rounded=read([f.to(torch.bfloat16) for f in factors]))
    for control in ("tf32_rounded", "bf16_rounded"):
        check(max(reading[control].values()) > FACTOR_RESIDUAL_LIMIT,
              "%s: factors rounded to %s pass the backward-error limit: %s"
              % (op, control[:4], reading))
    return max(got.values()) / FACTOR_RESIDUAL_LIMIT


def _lq_invariant(op, outs, host_outs, inputs, rows):
    """gelqf on the card, sign-free: L Q = A and Q Q^T = I within their
    backward-error limit, L lower triangular."""
    a = inputs[0].double()
    L, Q = (o._data for o in outs)

    def residuals(L, Q):
        qqt = Q @ Q.transpose(-1, -2)
        return {"reconstruction": (L @ Q, a),
                "orthogonality": (qqt, _eye_like(qqt))}

    return max(_factor_residuals(op, (L, Q), residuals, Q.shape[-2]),
               0.0 if bool((torch.triu(L, 1) == 0).all()) else float("inf"))


def _eig_invariant(op, outs, host_outs, inputs, rows):
    """syevd on the card, sign-free: U^T diag(w) U = A and U U^T = I
    within their backward-error limit, and w (ascending) the host's
    float64 eigenvalues at `rows` within the linalg family's limit."""
    a = inputs[0].double()
    U, w = (o._data for o in outs)

    def residuals(U, w):
        uut = U @ U.transpose(-1, -2)
        return {"reconstruction": (U.transpose(-1, -2) @ (w[..., None] * U),
                                   a),
                "orthogonality": (uut, _eye_like(uut))}

    return max(_factor_residuals(op, (U, w), residuals, U.shape[-2]),
               _share(w[rows].double().cpu(), host_outs[1]._data.cpu(),
                      *SURFACE_TOL["linalg"]))


def _syevd_ms(mx):
    """syevd at TAIL's SPD shape: the op (float64 on the card) against
    torch's float32 route, one call at a time (a reading)."""
    from mxnet_tpu_torch.ndarray.ndarray import NDArray, _invoke

    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    a = _spd(gen, "cuda", TAIL["spd"])
    x = NDArray(a, ctx=mx.gpu(0))
    return {"op": time_ms(lambda: _invoke("_linalg_syevd", [x]), iters=5,
                          warmup=1),
            "float32_route": time_ms(lambda: torch.linalg.eigh(a), iters=5,
                                     warmup=1)}


def _tail_cases():
    """Every name of TAIL_SURFACE_NAMES once: the two names of an
    operator take different attrs where it has them."""
    T = TAIL
    spd, rhs = T["spd"], T["spd"][:2] + (T["rhs"],)
    cases = []

    def add(op, family, make, **kw):
        cases.append(_Case(op, family, make, **kw))

    def chol(g, d):
        return torch.linalg.cholesky(_spd(g, d, spd))

    a, b = "_linalg_", "linalg_"
    add(a + "gemm", "linalg", lambda g, d: (
        [_rand(g, d, spd), _rand(g, d, spd), _rand(g, d, spd)], {}))
    add(b + "gemm", "linalg", lambda g, d: (
        [_rand(g, d, spd), _rand(g, d, spd), _rand(g, d, spd)],
        {"transpose_b": True, "alpha": 0.5, "beta": 2.0}))
    add(a + "gemm2", "linalg", lambda g, d: (
        [_rand(g, d, spd), _rand(g, d, rhs)], {}))
    add(b + "gemm2", "linalg", lambda g, d: (
        [_rand(g, d, spd), _rand(g, d, spd)], {"transpose_a": True}))
    add(a + "potrf", "linalg", lambda g, d: ([_spd(g, d, spd)], {}))
    add(b + "potrf", "linalg", lambda g, d: ([_spd(g, d, spd)],
                                             {"lower": False}))
    add(a + "potri", "linalg", lambda g, d: ([chol(g, d)], {}))
    add(b + "potri", "linalg", lambda g, d: (
        [chol(g, d).transpose(-1, -2).contiguous()], {"lower": False}))
    add(a + "trsm", "linalg", lambda g, d: ([chol(g, d), _rand(g, d, rhs)],
                                            {"alpha": 2.0}))
    add(b + "trsm", "linalg", lambda g, d: (
        [chol(g, d), _rand(g, d, rhs).transpose(-1, -2).contiguous()],
        {"rightside": True, "transpose": True}))
    add(a + "trmm", "linalg", lambda g, d: ([_rand(g, d, spd),
                                             _rand(g, d, rhs)], {}))
    add(b + "trmm", "linalg", lambda g, d: (
        [_rand(g, d, spd), _rand(g, d, rhs).transpose(-1, -2).contiguous()],
        {"rightside": True, "lower": False, "alpha": -1.5}))
    add(a + "syrk", "linalg", lambda g, d: ([_rand(g, d, T["lq"])], {}))
    add(b + "syrk", "linalg", lambda g, d: ([_rand(g, d, spd)],
                                            {"transpose": True,
                                             "alpha": 2.0}))
    for p in (a, b):
        add(p + "sumlogdiag", "linalg", lambda g, d: ([_spd(g, d, spd)], {}))
        add(p + "inverse", "linalg", lambda g, d: ([_spd(g, d, spd)], {}))
        add(p + "det", "linalg", lambda g, d: ([_spd(g, d, T["det"])], {}))
        # The sign has no gradient: forward only.
        add(p + "slogdet", "linalg", lambda g, d: ([_spd(g, d, spd)], {}),
            grad=None)
        # Signs of rows are not unique: invariants on the card.
        add(p + "gelqf", "linalg", lambda g, d: ([_rand(g, d, T["lq"])], {}),
            grad=None, invariant=_lq_invariant)
        add(p + "syevd", "linalg", lambda g, d: ([_spd(g, d, spd)], {}),
            grad=None, invariant=_eig_invariant)
    add("khatri_rao", "linalg", lambda g, d: (
        [_rand(g, d, s) for s in T["kr"]], {}), rows=None)

    c = "_contrib_"
    act, image = SURFACE["act"], SURFACE["image"]
    add(c + "AdaptiveAvgPooling2D", "reduce", lambda g, d: (
        [_rand(g, d, act)], {"output_size": T["pool"]}))
    add(c + "adaptive_avg_pooling2d", "reduce", lambda g, d: (
        [_rand(g, d, act)], {"output_size": (T["pool"], 5)}))
    add(c + "BilinearResize2D", "resampling", lambda g, d: (
        [_rand(g, d, image)], {"height": T["resize"],
                               "width": T["resize"]}))
    add(c + "bilinear_resize2d", "resampling", lambda g, d: (
        [_rand(g, d, image)], {"scale_height": 0.5, "scale_width": 0.75}))
    for name in ("fft", "FFT"):
        add(c + name, "linalg", lambda g, d: ([_rand(g, d, T["fft"])], {}))
    for name in ("ifft", "IFFT"):
        add(c + name, "linalg", lambda g, d: (
            [_rand(g, d, T["fft"][:1] + (2 * T["fft"][1],))], {}))

    def index_copy(g, d):
        n, width = T["embed"]
        idx = torch.randperm(n, generator=g, device=d)[:T["copy_rows"]]
        return ([_rand(g, d, T["embed"]), idx.float(),
                 _rand(g, d, (T["copy_rows"], width))], {})

    def sketch(g, d):
        n, features, buckets = T["sketch"]
        h = torch.randint(0, buckets, (1, features), generator=g, device=d)
        sign = torch.randint(0, 2, (1, features), generator=g, device=d)
        return ([_rand(g, d, (n, features)), h.float(),
                 (sign * 2 - 1).float()], {"out_dim": buckets})

    for name in ("index_copy", "IndexCopy"):
        add(c + name, "matrix", index_copy, wrt=(0, 2), rows=None)
    # s's gradient sums over every row: the host takes them all.
    for name in ("count_sketch", "CountSketch"):
        add(c + name, "reduce", sketch, wrt=(0, 2), rows=None)
    return cases


def _to_host(t, dtype):
    t = t.detach().cpu()
    return t.to(dtype) if t.is_floating_point() else t


def _run_case(mx, case, inputs, attrs, ctx, head_fn):
    """Forward (and gradients) of one case on `ctx`'s tensors `inputs`."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ndarray.ndarray import NDArray, _invoke

    arrays = [NDArray(t, ctx=ctx) for t in inputs]
    if case.grad is None:
        with ctx:
            out = _invoke(case.op, arrays, **attrs)
        return (out if isinstance(out, tuple) else (out,)), []
    wrt = range(len(arrays)) if case.wrt is None else case.wrt
    for i in wrt:
        arrays[i].attach_grad()
    with autograd.record():
        out = _invoke(case.op, arrays, **attrs)
        outs = out if isinstance(out, tuple) else (out,)
        head_of = outs[0] * arrays[0] if case.grad == "compose" else outs[0]
    head_of.backward(NDArray(head_fn(head_of.shape, head_of._data), ctx=ctx))
    return outs, [arrays[i].grad for i in wrt]


def _share(got, want, rtol, atol_rel):
    """max |got - want| / (atol + rtol |want|), atol = atol_rel max|want|;
    NaN where both are NaN counts as equal, and any other NaN fails."""
    got, want = got.double(), want.double()
    both_nan = torch.isnan(got) & torch.isnan(want)
    got = torch.where(both_nan, torch.zeros_like(got), got)
    want = torch.where(both_nan, torch.zeros_like(want), want)
    finite = torch.isfinite(want)
    if not bool((torch.isfinite(got) == finite).all()) or not bool(
            (got[~finite] == want[~finite]).all()):
        return float("inf")
    if not bool(finite.any()):
        return 0.0
    got, want = got[finite], want[finite]
    err = (got - want).abs()
    if rtol == 0 and atol_rel == 0:
        return 0.0 if bool((err == 0).all()) else float("inf")
    limit = atol_rel * float(want.abs().max()) + rtol * want.abs()
    return float((err / torch.clamp(limit, min=1e-300)).max())


def _compare_case(case, got, want, host_inputs, rows):
    """Worst share of the limit over a case's outputs and gradients, the
    card's taken at `rows` where the host computed only those. The
    index output of argsort and topk is compared on the rows whose
    input holds no tie."""
    rtol, atol_rel = SURFACE_TOL[case.family]
    worst = 0.0
    outs_got, grads_got = got
    outs_want, grads_want = want
    if case.invariant is not None:
        return case.invariant(case.op, outs_got, outs_want, host_inputs,
                              rows)
    for k, (g, w) in enumerate(zip(outs_got, outs_want)):
        g = _to_host(g._data, torch.float64)
        w = _to_host(w._data, torch.float64)
        if rows:
            g = g[rows]
        check(tuple(g.shape) == tuple(w.shape), "%s: shape %s on the card, "
              "%s on the host" % (case.op, tuple(g.shape), tuple(w.shape)))
        if case.op in ("topk", "argsort") and k == len(outs_got) - 1:
            row = torch.sort(host_inputs[0], dim=1).values
            untied = (row.diff(dim=1) != 0).all(dim=1)
            g, w = g[untied], w[untied]
        worst = max(worst, _share(g, w, rtol, atol_rel))
    grtol = max(rtol, SURFACE_GRAD_TOL[0])
    gatol = max(atol_rel, SURFACE_GRAD_TOL[1])
    for g, w in zip(grads_got, grads_want):
        g = _to_host(g._data, torch.float64)
        w = _to_host(w._data, torch.float64)
        if rows:
            g = g[rows]
        worst = max(worst, _share(g, w, grtol, gatol))
    return worst


def _short(attrs):
    text = str(attrs)
    return text if len(text) < 200 else text[:200] + "..."


def _op_bytes(inputs, outs):
    return sum(t.numel() * t.element_size() for t in inputs) + sum(
        o._data.numel() * o._data.element_size() for o in outs)


def _core_sweep(mx, dev, card_ctx, cases=None, sweep="core", queued=True):
    """(a): every deterministic operator of the core surface (or of
    `cases`) on the card against the host in float64. Each family's
    largest operator is timed with ``time_queued`` (device time), or,
    with `queued` False, with ``time_ms`` (one call at a time): an
    operator that waits on the card inside the call (a factorization
    reading its info word) never lets the host get ahead of a sleep
    kernel."""
    from mxnet_tpu_torch.ndarray.ndarray import NDArray, _invoke

    cases = _surface_cases() if cases is None else cases
    gen = torch.Generator(device=dev).manual_seed(SEED)
    families = {}
    ran = set()
    for case in cases:
        inputs, attrs = case.make(gen, dev)
        heads = []

        def card_head(shape, like):
            h = torch.ones(shape, dtype=like.dtype, device=like.device) \
                if case.grad == "loss" else torch.empty(
                    shape, dtype=like.dtype, device=like.device).uniform_(
                        0.5, 1.5, generator=gen)
            heads.append(h)
            return h

        batch = inputs[0].shape[0] if inputs and inputs[0].dim() else None
        rows = _host_rows(batch) if case.rows and batch else None

        def host_head(shape, like):
            return _to_host(heads[0][rows] if rows else heads[0],
                            like.dtype).reshape(shape)

        got = _run_case(mx, case, inputs, attrs, card_ctx, card_head)
        # Rows: the host takes those rows of every input that has the
        # first input's rows.
        host_in = [_to_host(t[rows] if rows and t.dim()
                            and t.shape[0] == batch else t,
                            case.host_dtype) for t in inputs]
        with mx.cpu():
            want = _run_case(mx, case, host_in, attrs, mx.cpu(), host_head)
        share = _compare_case(case, got, want,
                              inputs if case.invariant else host_in, rows)
        check(share <= 1.0, "core surface: %s %s on the card vs the host: "
              "%.3g of its limit" % (case.op, _short(attrs), share))
        fam = families.setdefault(case.family, {
            "ops": set(), "runs": 0, "worst_share": 0.0, "largest": None})
        fam["ops"].add(case.op)
        fam["runs"] += 1
        fam["worst_share"] = max(fam["worst_share"], share)
        nbytes = _op_bytes(inputs, got[0])
        if fam["largest"] is None or nbytes > fam["largest"][0]:
            fam["largest"] = (nbytes, case, inputs, attrs)
        ran.add(case.op)
        del got, want, inputs, host_in
    lines = {}
    for name, fam in sorted(families.items()):
        nbytes, case, inputs, attrs = fam["largest"]
        arrays = [NDArray(t, ctx=card_ctx) for t in inputs]
        timer = time_queued if queued else time_ms
        kw = {"reps": 5, "iters": 3} if queued else {"iters": 5,
                                                     "warmup": 1}
        with card_ctx:
            ms = timer(lambda: _invoke(case.op, arrays, **attrs),
                       **kw) if dev == "cuda" else None
        lines[name] = {"ops": len(fam["ops"]), "runs": fam["runs"],
                       "worst_share_of_limit": fam["worst_share"],
                       "tolerance": SURFACE_TOL[name],
                       "largest_op": case.op, "largest_op_bytes": nbytes,
                       ("largest_op_device_ms" if queued
                        else "largest_op_ms"): ms}
        log(json.dumps({"check": "core surface family", "sweep": sweep,
                        "family": name, **lines[name]}))
    return ran, lines


def _determinism(mx, dev, card_ctx):
    """The accumulating operators under torch.use_deterministic_algorithms
    (set here, restored after): they run, and twice give the same
    bits."""
    from mxnet_tpu_torch.ndarray.ndarray import NDArray, _invoke

    lm = SURFACE["lm"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    data = NDArray(_rand(gen, dev, (2 * lm[0],)), ctx=card_ctx)
    idx = NDArray(torch.stack([_idx(gen, dev, 2 * lm[0], lm[0]),
                               _idx(gen, dev, 2 * lm[0], lm[1])]),
                  ctx=card_ctx)
    x = NDArray(torch.randn(SURFACE["act"], generator=gen, device=dev),
                ctx=card_ctx)
    runs = {"_scatter_nd_add": lambda: _invoke("_scatter_nd_add",
                                               [data, idx], shape=lm),
            "histogram": lambda: _invoke("histogram", [x], bin_cnt=20,
                                         range=(-3.0, 3.0))[0],
            "cumsum": lambda: _invoke("cumsum", [x], axis=3),
            "topk": lambda: _invoke("topk", [x], axis=3, k=5)}
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        for name, fn in runs.items():
            check(torch.equal(fn()._data, fn()._data),
                  "%s differs between two runs under deterministic "
                  "algorithms" % name)
    finally:
        torch.use_deterministic_algorithms(was[0])
        torch.backends.cudnn.deterministic = was[1]
    return sorted(runs)


def _law_cases():
    """(op, inputs maker, attrs, law) for every RNG operator of the core
    surface; a law is ("ks", scipy distribution) or ("chi2", pmf,
    support), applied per row where the op draws rows."""
    import scipy.stats as st

    n = SURFACE["draws"]
    lm_rows = np.array([0.6, 4.0], np.float32)

    def rows(*vals):
        return lambda d: [torch.tensor(v, dtype=torch.float32, device=d)
                          for v in vals]

    def none(d):
        return []

    zipf = 100
    return [
        ("_random_uniform", none, {"low": -2.0, "high": 3.0, "shape": (n,)},
         [("ks", st.uniform(-2.0, 5.0))]),
        ("_random_normal", none, {"loc": 1.0, "scale": 2.0, "shape": (n,)},
         [("ks", st.norm(1.0, 2.0))]),
        ("normal_like", lambda d: [torch.zeros((n,), device=d)],
         {"loc": -1.0, "scale": 0.5}, [("ks", st.norm(-1.0, 0.5))]),
        ("_random_gamma", none, {"alpha": 0.3, "beta": 2.0, "shape": (n,)},
         [("ks", st.gamma(0.3, scale=2.0))]),
        ("_random_exponential", none, {"lam": 2.0, "shape": (n,)},
         [("ks", st.expon(scale=0.5))]),
        ("_random_poisson", none, {"lam": 3.0, "shape": (n,)},
         [("chi2", st.poisson(3.0).pmf, np.arange(20))]),
        ("_random_negative_binomial", none, {"k": 3, "p": 0.4,
                                             "shape": (n,)},
         [("chi2", st.nbinom(3, 0.4).pmf, np.arange(40))]),
        ("_random_generalized_negative_binomial", none,
         {"mu": 2.0, "alpha": 0.5, "shape": (n,)},
         [("chi2", st.nbinom(2.0, 0.5).pmf, np.arange(30))]),
        ("_random_randint", none, {"low": -3, "high": 7, "shape": (n,)},
         [("chi2", lambda k: 0.1, np.arange(-3, 7))]),
        ("sample_multinomial",
         rows(np.array([0.1, 0.2, 0.3, 0.4], np.float32)), {"shape": n},
         [("chi2", lambda k: (k + 1) / 10.0, np.arange(4))]),
        ("_sample_unique_zipfian", none, {"range_max": zipf, "shape": (n,)},
         [("chi2", lambda k: math.log((k + 2) / (k + 1))
           / math.log(zipf + 1), np.arange(zipf))]),
        ("_shuffle", lambda d: [torch.arange(n, dtype=torch.float32,
                                             device=d)], {},
         [("permutation", st.uniform(0, n))]),
        ("_sample_uniform", rows(lm_rows, lm_rows * 3), {"shape": (n // 2,)},
         [("ks", st.uniform(v, 2 * v)) for v in lm_rows]),
        ("_sample_normal", rows(lm_rows, lm_rows), {"shape": (n // 2,)},
         [("ks", st.norm(v, v)) for v in lm_rows]),
        ("_sample_gamma", rows(lm_rows, 1 / lm_rows), {"shape": (n // 2,)},
         [("ks", st.gamma(v, scale=1 / v)) for v in lm_rows]),
        ("_sample_exponential", rows(lm_rows), {"shape": (n // 2,)},
         [("ks", st.expon(scale=1 / v)) for v in lm_rows]),
        ("_sample_poisson", rows(lm_rows * 5), {"shape": (n // 2,)},
         [("chi2", st.poisson(v).pmf, np.arange(60))
          for v in lm_rows * 5]),
    ]


P_LAW = 1e-4


def _hold_law(op, x, law):
    """The p-value of `x` (float64 numpy) under `law`; fails below
    P_LAW."""
    import scipy.stats as st

    kind = law[0]
    if kind == "ks":
        p = st.kstest(x, law[1].cdf).pvalue
    elif kind == "permutation":
        check(np.array_equal(np.sort(x), np.arange(x.size)),
              "%s is not a permutation" % op)
        # Where the smallest tenth landed: uniform over the positions.
        pos = np.argsort(x)[:x.size // 10].astype(np.float64)
        p = st.kstest(pos, law[1].cdf).pvalue
    else:
        pmf, support = law[1], law[2]
        counts = np.array([np.sum(x == k) for k in support]
                          + [np.sum(~np.isin(x, support))], np.float64)
        probs = np.array([pmf(k) for k in support], np.float64)
        probs = np.append(probs, max(1.0 - probs.sum(), 0.0))
        keep = probs * x.size > 5
        f_obs = np.append(counts[keep], counts[~keep].sum())
        f_exp = np.append(probs[keep], probs[~keep].sum()) * x.size
        if f_exp[-1] == 0:
            f_obs, f_exp = f_obs[:-1], f_exp[:-1]
        p = st.chisquare(f_obs, f_exp * f_obs.sum() / f_exp.sum()).pvalue
    check(p > P_LAW, "%s: its draws fail their law (p = %.3g)" % (op, p))
    return float(p)


def _core_rng(mx, dev, card_ctx):
    """(b): every RNG operator draws 10^6 values on the card, held to its
    law; a reseed replays them bit for bit."""
    from mxnet_tpu_torch.ndarray.ndarray import NDArray, _invoke

    out = {}
    for op, make, attrs, laws in _law_cases():
        def draw():
            mx.random.seed(SEED + 7)
            with card_ctx:
                r = _invoke(op, [NDArray(t, ctx=card_ctx)
                                 for t in make(dev)], **attrs)
            return r if not isinstance(r, tuple) else r[0]

        first = draw()
        check(first.context == card_ctx, "%s drew off the card" % op)
        again = draw()
        check(torch.equal(first._data, again._data), "%s: a reseed did "
              "not replay its draws" % op)
        x = first.asnumpy().astype(np.float64)
        x = x.reshape(len(laws), -1)
        ps = [_hold_law(op, x[i], law) for i, law in enumerate(laws)]
        out[op] = {"draws": int(first.size), "min_p": min(ps)}
    log(json.dumps({"check": "core surface RNG", "p_min": P_LAW,
                    "ops": out}))
    return out


# Phase 17's training loop: the stored batch's side, the crop, the
# batch size and the network.
CORE_RESNET = {"side": 256, "crop": 224, "batch": 32,
               "network": "resnet50_v1"}


def _core_resnet(mx, steps=20, warmup=2):
    """(c): ResNet-50 v1 through the reference's Gluon image-classification
    loop, on the core surface (module docstring, phase 17)."""
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision

    gpu = mx.gpu(0)
    side, crop, b = (CORE_RESNET[k] for k in ("side", "crop", "batch"))
    mx.random.seed(SEED)
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(getattr(vision, CORE_RESNET["network"])(classes=1000))
    net.initialize(mx.init.MSRAPrelu(), ctx=gpu)
    net.hybridize()
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    trainer = gluon.Trainer(net.collect_params(), "sgd", TRAINER_OPT)
    ce = gluon.loss.SoftmaxCrossEntropyLoss()
    top5 = mx.metric.TopKAccuracy(5)
    rng = np.random.default_rng(SEED)
    # Each image a colour of its own under noise, so that crops and
    # mirrors keep what identifies it.
    batch = (rng.random((b, 3, side, side), dtype=np.float32) * 0.5
             + rng.random((b, 3, 1, 1), dtype=np.float32) * 2)
    labels = rng.integers(0, 1000, b).astype(np.float32)
    (data,) = gluon.utils.split_and_load(batch, [gpu])
    y = nd.array(labels, ctx=gpu)
    max_norm = 20.0
    losses, norms, clipped, crops = [], [], 0, []
    norm_check = topk_check = None
    t0 = None
    for step in range(steps):
        if step == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        span = side - crop + 1
        off = nd.random.uniform(0, span, shape=(3,), ctx=gpu).asnumpy()
        oy, ox, mirror = int(off[0]), int(off[1]), off[2] < span / 2
        x = nd.slice(data, begin=(None, None, oy, ox),
                     end=(None, None, oy + crop, ox + crop))
        if mirror:
            x = nd.flip(x, axis=3)
        crops.append([oy, ox, bool(mirror)])
        with autograd.record():
            out = net(x)
            loss = ce(out, y)
        loss.backward()
        grads = [p.grad(gpu) for p in params]
        if step == 0:
            host = math.sqrt(sum(float((g.asnumpy().astype(np.float64) ** 2)
                                       .sum()) for g in grads))
        norm = gluon.utils.clip_global_norm(grads, max_norm)
        if step == 0:
            norm_check = {"clip_global_norm": norm, "host_float64": host,
                          "rel_err": abs(norm - host) / host}
            check(norm_check["rel_err"] <= 1e-5, "clip_global_norm's norm "
                  "%r vs the host's float64 %r" % (norm, host))
            got = nd.topk(out, k=5)._data.long()
            want = torch.topk(out._data, 5, dim=1).indices
            vals = torch.sort(out._data, dim=1, descending=True).values
            untied = (vals[:, :6].diff(dim=1) != 0).all(dim=1)
            topk_check = {"rows": int(untied.sum()),
                          "equal": bool(torch.equal(got[untied],
                                                    want[untied]))}
            check(topk_check["equal"], "nd.topk differs from torch.topk")
        clipped += norm > max_norm
        norms.append(norm)
        trainer.step(b)
        top5.update([y], [out])
        losses.append(float(loss.mean().asscalar()))
    torch.cuda.synchronize()
    img_s = b * (steps - warmup) / (time.perf_counter() - t0)
    result = {"steps": steps, "batch": b, "losses": losses,
              "grad_norms": norms, "max_norm": max_norm,
              "clipped_steps": int(clipped), "crops": crops,
              "norm_check": norm_check, "topk_check": topk_check,
              "top5": top5.get()[1], "img_s": img_s,
              "names_under_name_scope": list(net.collect_params())[:2]}
    check(all(np.isfinite(losses)), "non-finite loss: %s" % losses)
    check(np.mean(losses[-3:]) < np.mean(losses[:3]), "the loss did not "
          "fall: %s" % losses)
    del net, trainer
    torch.cuda.empty_cache()
    return result


def phase_core_surface(card_line, trainer_img_s):
    """Phase 17: the core surface (see the module docstring)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry

    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    t_phase = time.perf_counter()
    result = {"phase": "core_surface", "card": card_line}
    ops = {registry.get(n).name for n in CORE_SURFACE_NAMES}
    rng_ops = {o for o in ops if registry.get(o).needs_rng}
    _reset_all_launches()   # the main path starts here
    ran, result["families"] = _core_sweep(mx, "cuda", mx.gpu(0))
    t_tail = time.perf_counter()
    tail_ran, result["tail_families"] = _core_sweep(
        mx, "cuda", mx.gpu(0), _tail_cases(), sweep="tail", queued=False)
    result["tail_seconds"] = time.perf_counter() - t_tail
    result["factor_backward_errors"] = FACTOR_READINGS
    result["syevd_ms"] = _syevd_ms(mx)
    result["deterministic_reruns"] = _determinism(mx, "cuda", mx.gpu(0))
    result["rng"] = _core_rng(mx, "cuda", mx.gpu(0))
    result["resnet50_loop"] = _core_resnet(mx)
    launches = _all_launches()   # read just after the path
    result["launches"] = launches
    ran |= set(result["rng"])
    result["canonical_ops"] = {"registered": len(ops), "ran": len(ran),
                               "rng": len(rng_ops)}
    result["resnet50_loop"]["trainer_img_s_phase11"] = trainer_img_s
    result["seconds"] = time.perf_counter() - t_phase
    log(json.dumps(result))
    check(ran == ops, "core surface: ops not run %s, run but not "
          "registered by the surface %s" % (sorted(ops - ran),
                                            sorted(ran - ops)))
    tail = set(TAIL_SURFACE_NAMES)
    check(tail_ran == tail, "the registry's tail: names not run %s, run "
          "but not listed %s" % (sorted(tail - tail_ran),
                                 sorted(tail_ran - tail)))
    check(tail | set(CORE_SURFACE_NAMES) <= set(registry.OP_REGISTRY),
          "a swept name is not registered")
    return result


# Phase 18: the model zoo. Training rows at BASELINE.md's training table
# (:11-20): Inception-v3 at b32, 299 px; AlexNet at b32 x 16 = 512 (its
# reference column runs 16 times the listed batch) and at b32. Served
# rows at its V100 inference table (:26-30): VGG-16 and Inception-v3, b32.
ZOO_TRAIN = (("inception-v3", 32, (3, 299, 299)),
             ("alexnet", 512, (3, 224, 224)),
             ("alexnet", 32, (3, 224, 224)))
ZOO_SERVED = (("vgg16", 224), ("inceptionv3", 299))
# Timed windows of each training row (benchmark_rate's median): 2, not
# its default 5, of 8 steps at b32 and 5 at b512, not 16 and 10, to keep
# the whole script's time as phases are added.
ZOO_WINDOWS = 2
ZOO_ITERS = {32: 6, 512: 4}
# The reference's published V100 img/s (BASELINE.md:17, 28, 35): a
# reading beside ours, not a target.
ZOO_REFERENCE_V100 = {"inceptionv3_train_b32": 214.48,
                      "alexnet_train_b32x16": 2585.61,
                      "vgg16_infer_b32_fp32": 708.43,
                      "inceptionv3_infer_b32_fp32": 814.59,
                      "vgg16_infer_b32_fp16": 1486.63,
                      "inceptionv3_infer_b32_fp16": 1512.08}
# Every family at batch 2 and its standard input, one train-mode forward
# and backward (Dropout at rate 0: the card's and the host's masks come
# from different generators) in float64 on the card against the host,
# from the same weights: relative L2 over the logits, over the gradients
# of the input and every trainable parameter, and over the running
# statistics after the step. In float64 a ReLU input within rounding of
# zero is too rare to flip, so the two agree to float64 rounding summed
# through the net.
ZOO_FAMILIES = {"alexnet": 224, "vgg11": 224, "squeezenet1.1": 224,
                "mobilenet1.0": 224, "mobilenetv2_1.0": 224,
                "densenet121": 224, "inceptionv3": 299}
ZOO_F64_REL_L2 = 1e-9
# Steps a profiled window (torch.profiler's host-side bookkeeping of an
# Inception-v3 step costs seconds).
ZOO_PROFILE_ITERS = 2
# Every layer and loss of the slice at a model's width, on the card in
# fp32 against the host in float64 (SURFACE_TOL["nn"], gradients
# SURFACE_GRAD_TOL): (class, constructor arguments, input shape) — a
# ResNet stage's activation, BERT-base's LayerNorm input, Kim's text CNN
# (300-wide embeddings, 60 tokens), a C3D stage, a DCGAN generator's
# upsampling, a style-transfer net's normalization and padding.
ZOO_LAYERS = (
    ("InstanceNorm", {"scale": True}, (8, 64, 64, 64)),
    ("LayerNorm", {}, (32, 128, 768)),
    ("LeakyReLU", {"alpha": 0.1}, (32, 512, 14, 14)),
    ("PReLU", {}, (32, 512, 14, 14)),
    ("ELU", {"alpha": 1.0}, (32, 512, 14, 14)),
    ("SELU", {}, (32, 512, 14, 14)),
    ("GELU", {}, (32, 512, 14, 14)),
    ("Swish", {"beta": 1.0}, (32, 512, 14, 14)),
    ("Lambda", {"function": "tanh"}, (32, 512, 14, 14)),
    ("HybridLambda", {"function": "tanh"}, (32, 512, 14, 14)),
    ("Conv1D", {"channels": 100, "kernel_size": 3}, (32, 300, 60)),
    ("Conv3D", {"channels": 32, "kernel_size": 3, "padding": 1},
     (4, 32, 8, 28, 28)),
    ("Conv1DTranspose", {"channels": 64, "kernel_size": 4, "strides": 2,
                         "padding": 1}, (32, 128, 60)),
    ("Conv2DTranspose", {"channels": 64, "kernel_size": 4, "strides": 2,
                         "padding": 1}, (32, 128, 16, 16)),
    ("Conv3DTranspose", {"channels": 16, "kernel_size": 4, "strides": 2,
                         "padding": 1}, (4, 32, 4, 14, 14)),
    ("MaxPool1D", {"pool_size": 3, "strides": 2}, (32, 300, 60)),
    ("MaxPool3D", {"pool_size": 2}, (8, 64, 8, 28, 28)),
    ("AvgPool1D", {"pool_size": 3, "strides": 2, "padding": 1,
                   "count_include_pad": False}, (32, 300, 60)),
    ("AvgPool3D", {"pool_size": 2, "padding": 1}, (8, 64, 8, 28, 28)),
    ("GlobalMaxPool1D", {}, (32, 100, 58)),
    ("GlobalMaxPool3D", {}, (8, 64, 4, 7, 7)),
    ("GlobalAvgPool1D", {}, (32, 100, 58)),
    ("GlobalAvgPool3D", {}, (8, 64, 4, 7, 7)),
    ("ReflectionPad2D", {"padding": 4}, (8, 64, 64, 64)),
)
# (class, constructor arguments, input kinds) at the ImageNet logits' or a
# GAN's widths; each with a per-sample sample_weight.
ZOO_LOSSES = (
    ("SigmoidBinaryCrossEntropyLoss", {}, ("pred", "binary")),
    ("SigmoidBCELoss", {"from_sigmoid": True}, ("prob", "binary")),
    ("KLDivLoss", {"from_logits": False}, ("pred", "dist")),
    ("HuberLoss", {"rho": 0.5}, ("pred", "pred")),
    ("HingeLoss", {}, ("pred", "signed")),
    ("SquaredHingeLoss", {}, ("pred", "signed")),
    ("LogisticLoss", {}, ("pred", "signed")),
    ("TripletLoss", {"margin": 0.5}, ("pred", "pred", "pred")),
)
ZOO_LOSS_SHAPE = (32, 1000)
# CTC at a speech recognizer's widths: 32 utterances of up to 100 frames
# over 29 characters and the blank, labels of 5-20 characters.
ZOO_CTC = {"T": 100, "N": 32, "C": 30, "min_label": 5, "max_label": 20,
           "reruns": 5}
ZOO_OPS = ("ctc_loss", "CTCLoss", "_contrib_ctc_loss", "_contrib_CTCLoss")


def _without_dropout(net):
    """`net` with the rate of each Dropout layer in it set to 0."""
    todo = [net]
    while todo:
        block = todo.pop()
        if type(block).__name__ == "Dropout":
            block._rate = 0.0
        todo.extend(block._children.values())
    return net


def _zoo_rates(mx, card_line):
    """Train img/s (benchmark_rate, fp32 TF32 off and bf16 over fp32
    masters) and served forward img/s at b32 (fp32, bf16)."""
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.examples import train_imagenet
    from mxnet_tpu_torch.gluon.model_zoo import vision

    train = {}
    for network, batch, shape in ZOO_TRAIN:
        row = {"batch": batch, "image_shape": list(shape),
               "iters_per_window": ZOO_ITERS[batch],
               "windows": ZOO_WINDOWS, "card": card_line}
        for tag, dtype in (("fp32", None), ("bf16", "bfloat16")):
            t0 = time.perf_counter()
            rate = train_imagenet.benchmark_rate(
                network, batch, dtype, device=mx.gpu(0), image_shape=shape,
                iters=ZOO_ITERS[batch], windows=ZOO_WINDOWS)
            row[tag] = {"img_s": rate, "ms_per_step": batch * 1e3 / rate,
                        "seconds": time.perf_counter() - t0}
            torch.cuda.empty_cache()
        train["%s_b%d" % (network, batch)] = row
        log(json.dumps({"check": "model zoo train", "network": network,
                        **row}))
    served = {}
    rng = np.random.default_rng(SEED)
    for name, side in ZOO_SERVED:
        mx.random.seed(SEED)
        net = vision.get_model(name, classes=1000)
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net.hybridize()
        x = nd.array(rng.random((32, 3, side, side), dtype=np.float32),
                     ctx=mx.gpu(0))
        row = {"batch": 32, "side": side, "card": card_line}
        for tag, dtype in (("fp32", "float32"), ("bf16", "bfloat16")):
            if dtype != "float32":
                net.cast(dtype)
            xin = x.astype(dtype)

            def forward():
                with torch.no_grad(), autograd.pause():
                    net(xin).wait_to_read()

            ms = time_ms(forward)
            row[tag] = {"forward_ms": ms, "img_s": 32e3 / ms}
        served[name] = row
        log(json.dumps({"check": "model zoo served", "network": name,
                        **row}))
        del net
        torch.cuda.empty_cache()
    return train, served


def _zoo_device_split(mx):
    """One torch.profiler line a new training path: wall, enqueue and
    device ms per step, idle share, top device ops."""
    from mxnet_tpu_torch.examples import train_imagenet
    from mxnet_tpu_torch.profile_serving import _profile

    lines = {}
    rng = np.random.default_rng(SEED)
    for network, batch, shape in ZOO_TRAIN[:2]:
        x = torch.from_numpy(rng.random((batch,) + shape,
                                        dtype=np.float32)).cuda()
        y = torch.from_numpy(rng.integers(0, 1000, batch)
                             .astype(np.float32)).cuda()
        for tag, dtype in (("fp32", None), ("bf16", "bfloat16")):
            step = train_imagenet.build_train_step(network, 1000, dtype,
                                                   mx.gpu(0))
            step(x, y)  # materialize
            key = "%s_b%d_%s" % (network, batch, tag)
            lines[key] = _profile("%s train %s b%d" % (network, tag, batch),
                                  lambda: step(x, y), iters=ZOO_PROFILE_ITERS)
            del step
            torch.cuda.empty_cache()
    return lines


def _f64_step(mx, net, x, y, ctx):
    """Train-mode logits, gradients ("<input>" the input's) and running
    statistics after one float64 step, by relative name."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.utils import relative_names

    xa = mx.nd.array(x, ctx=ctx, dtype="float64")
    xa.attach_grad()
    with autograd.record():
        out = net(xa)
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            out, mx.nd.array(y, ctx=ctx, dtype="float64")).sum()
    loss.backward()
    rel = relative_names(list(net.collect_params().keys()), net.prefix)
    params = net.collect_params().items()
    grads = {rel[n]: p.grad(ctx).asnumpy() for n, p in params
             if p.grad_req != "null"}
    grads["<input>"] = xa.grad.asnumpy()
    stats = {rel[n]: p.data(ctx).asnumpy() for n, p in params
             if n.endswith(("running_mean", "running_var"))}
    return {"logits": {"": out.asnumpy()}, "grads": grads, "stats": stats}


def _zoo_family(mx, name, side):
    """(a) The family on the card against the host in float64; (b) its
    hybridized inference forward on the card equal to the imperative
    one (fp32)."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.gluon.utils import params_from_numpy

    gpu = mx.gpu(0)
    rng = np.random.default_rng(SEED + side)
    x = rng.random((2, 3, side, side), dtype=np.float32)
    y = rng.integers(0, 1000, 2).astype(np.float32)
    mx.random.seed(SEED)
    net = vision.get_model(name, classes=1000)
    net.initialize(mx.init.Xavier(), ctx=gpu)
    with autograd.pause():
        imperative = net(mx.nd.array(x, ctx=gpu)).asnumpy()
        net.hybridize()
        hybrid = net(mx.nd.array(x, ctx=gpu)).asnumpy()
        net.hybridize(False)
    hybrid_err = float(np.abs(hybrid - imperative).max()
                       / np.abs(imperative).max())
    weights = {p.name: p.data(gpu).asnumpy()
               for p in net.collect_params().values()}
    prefix = net.prefix
    net.cast("float64")
    card = _f64_step(mx, _without_dropout(net), x, y, gpu)
    del net
    with mx.cpu():
        host_net = vision.get_model(name, classes=1000)
        host_net.initialize(ctx=mx.cpu())
        params_from_numpy(host_net, weights, prefix=prefix)
        host_net.cast("float64")
        host = _f64_step(mx, _without_dropout(host_net), x, y, mx.cpu())
    del host_net
    torch.cuda.empty_cache()
    errs = {}
    for part in ("logits", "grads", "stats"):
        check(set(card[part]) == set(host[part]), "%s: %s names differ "
              "card vs host" % (name, part))
        if host[part]:
            errs[part] = _rel_l2(card[part], host[part])
    return {"side": side, "batch": 2, "tensors": len(host["grads"]),
            "f64_rel_l2": errs, "limit": ZOO_F64_REL_L2,
            "hybrid_vs_imperative_rel": hybrid_err,
            "hybrid_bit_equal": bool(np.array_equal(hybrid, imperative))}


def _zoo_input(gen, kind, shape):
    """A float32 host array of `kind` for the loss sweep."""
    if kind == "pred":
        return gen.uniform(-3, 3, shape).astype(np.float32)
    if kind == "prob":
        return gen.uniform(0.02, 0.98, shape).astype(np.float32)
    if kind == "binary":
        return gen.integers(0, 2, shape).astype(np.float32)
    if kind == "signed":
        return gen.integers(0, 2, shape).astype(np.float32) * 2 - 1
    d = gen.uniform(0.1, 1, shape).astype(np.float32)  # "dist"
    return d / d.sum(axis=-1, keepdims=True)


def _zoo_block_case(mx, make, arrays, wrt, gen, between=()):
    """Worst share of the "nn" limit of one block (layer or loss): the
    card in fp32 against the host in float64, forward and the gradients
    of `wrt` and of every trainable parameter, from the same weights."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.utils import params_from_numpy, relative_names

    runs = []
    head = None
    weights = None
    for ctx, dtype in ((mx.gpu(0), "float32"), (mx.cpu(), "float64")):
        with ctx:
            block = make()
            block.initialize(ctx=ctx)
            nds = [mx.nd.array(a, ctx=ctx, dtype=dtype) for a in arrays]
            if weights is None:
                with autograd.pause():
                    block(*nds, *between)  # deferred shapes
                for p in block.collect_params().values():
                    p.set_data(gen.uniform(0.5, 1.5, p.shape)
                               .astype(np.float32))
                weights = ({p.name: p.data(ctx).asnumpy() for p in
                            block.collect_params().values()}, block.prefix)
            else:
                params_from_numpy(block, weights[0], prefix=weights[1])
                block.cast(dtype)
            for i in wrt:
                nds[i].attach_grad()
            with autograd.record():
                out = block(*nds, *between)
            if head is None:
                head = gen.uniform(0.5, 1.5, out.shape).astype(np.float32)
            out.backward(mx.nd.array(head, ctx=ctx, dtype=dtype))
            rel = relative_names(list(block.collect_params().keys()),
                                 block.prefix)
            grads = {rel[n]: p.grad(ctx).asnumpy() for n, p in
                     block.collect_params().items() if p.grad_req != "null"}
            grads.update({"<input %d>" % i: nds[i].grad.asnumpy()
                          for i in wrt})
            runs.append((out.asnumpy(), grads))
    (got, got_g), (want, want_g) = runs
    rtol, atol_rel = SURFACE_TOL["nn"]
    share = _share(torch.from_numpy(got), torch.from_numpy(want), rtol,
                   atol_rel)
    grtol = max(rtol, SURFACE_GRAD_TOL[0])
    gatol = max(atol_rel, SURFACE_GRAD_TOL[1])
    check(set(got_g) == set(want_g), "gradient names differ card vs host")
    for n, w in want_g.items():
        share = max(share, _share(torch.from_numpy(got_g[n]),
                                  torch.from_numpy(w), grtol, gatol))
    return share


def _zoo_ctc_arrays(gen):
    """(pred (T, N, C), label, pred_lengths): random lengths, repeated
    labels; row 0 has no label, row 1 cannot align (max_label labels in
    half as many frames)."""
    c = ZOO_CTC
    T, N, C = c["T"], c["N"], c["C"]
    pred = gen.standard_normal((T, N, C)).astype(np.float32) * 2
    label = np.full((N, c["max_label"]), -1, np.float32)
    lengths = gen.integers(c["min_label"], c["max_label"] + 1, N)
    pred_len = gen.integers(T * 3 // 5, T + 1, N).astype(np.float32)
    for i, n in enumerate(lengths):
        row = gen.integers(0, C - 1, n)
        row[1::4] = row[0::4][:len(row[1::4])]  # repeats
        label[i, :n] = row
    label[0] = -1
    label[1] = gen.integers(0, C - 1, c["max_label"])
    pred_len[1] = c["max_label"] // 2
    return pred, label, pred_len


def _zoo_ctc(mx, gen):
    """ctc_loss on the card (ATen's CTC) against the host's float64
    recursion, loss and gradient; the impossible row exactly the JAX
    package's 1e30 with a zero gradient; the spread of the card's
    gradient over reruns (its backward accumulates with atomics) and
    whether deterministic mode refuses it."""
    from mxnet_tpu_torch import autograd

    pred, label, pred_len = _zoo_ctc_arrays(gen)
    head = gen.uniform(0.5, 1.5, pred.shape[1]).astype(np.float32)
    runs = []
    called = ["_contrib_ctc_loss", "ctc_loss", "CTCLoss"]
    for ctx, dtype in ((mx.gpu(0), "float32"), (mx.cpu(), "float64")):
        p = mx.nd.array(pred, ctx=ctx, dtype=dtype)
        p.attach_grad()
        with autograd.record():
            loss = mx.nd.contrib.ctc_loss(p, mx.nd.array(label, ctx=ctx),
                                          mx.nd.array(pred_len, ctx=ctx))
        loss.backward(mx.nd.array(head, ctx=ctx, dtype=dtype))
        runs.append((loss.asnumpy(), p.grad.asnumpy()))
    (got, got_g), (want, want_g) = runs
    ok = np.ones(len(want), bool)
    ok[1] = False
    check(got[1] == np.float32(1e30) and want[1] == 1e30
          and not got_g[:, 1].any() and not want_g[:, 1].any(),
          "ctc_loss: the impossible row is not 1e30 with a zero gradient "
          "(card %r, host %r)" % (got[1], want[1]))
    rtol, atol_rel = SURFACE_TOL["nn"]
    share = max(
        _share(torch.from_numpy(got[ok]), torch.from_numpy(want[ok]),
               rtol, atol_rel),
        _share(torch.from_numpy(got_g), torch.from_numpy(want_g),
               max(rtol, SURFACE_GRAD_TOL[0]),
               max(atol_rel, SURFACE_GRAD_TOL[1])))
    # gluon.loss.CTCLoss (F.ctc_loss) in NTC layout over the same data.
    block_share = _zoo_block_case(
        mx, lambda: mx.gluon.loss.CTCLoss(layout="NTC"),
        [pred.transpose(1, 0, 2).copy(), label], [0], gen,
        between=(None, None))
    # Reruns of the card's backward.
    p = mx.nd.array(pred, ctx=mx.gpu(0))
    grads = []
    for _ in range(ZOO_CTC["reruns"]):
        p.attach_grad()
        with autograd.record():
            loss = mx.nd.ctc_loss(p, mx.nd.array(label, ctx=mx.gpu(0)),
                                  mx.nd.array(pred_len, ctx=mx.gpu(0)))
        loss.backward(mx.nd.array(head, ctx=mx.gpu(0)))
        grads.append(p.grad.asnumpy())
    spread = max(float(np.abs(g - grads[0]).max()) for g in grads)
    refused = None
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        p.attach_grad()
        with autograd.record():
            loss = mx.nd.ctc_loss(p, mx.nd.array(label, ctx=mx.gpu(0)))
        loss.backward()
        p.grad.wait_to_read()
        refused = False
    except RuntimeError as err:  # torch's determinism alert
        refused = str(err).splitlines()[0][:160]
    finally:
        torch.use_deterministic_algorithms(was)
    return {"T": pred.shape[0], "N": pred.shape[1], "C": pred.shape[2],
            "worst_share_of_limit": max(share, block_share),
            "op_share": share, "block_share": block_share,
            "impossible_row": float(got[1]),
            "grad_rerun_spread_max_abs": spread,
            "grad_max_abs": float(np.abs(grads[0]).max()),
            "deterministic": spread == 0.0,
            "refused_under_deterministic_algorithms": refused,
            "operators_called": called}


def _zoo_surface(mx):
    """Every new layer and loss, and ctc_loss, on the card against the
    host in float64."""
    from mxnet_tpu_torch import gluon

    gen = np.random.default_rng(SEED + 18)
    layers = {}
    for name, kwargs, shape in ZOO_LAYERS:
        x = gen.uniform(-2, 2, shape).astype(np.float32)
        layers[name] = _zoo_block_case(
            mx, lambda: getattr(gluon.nn, name)(**kwargs), [x], [0], gen)
        check(layers[name] <= 1.0, "layer %s on the card vs the host: "
              "%.3g of its limit" % (name, layers[name]))
    losses = {}
    for name, kwargs, kinds in ZOO_LOSSES:
        arrays = [_zoo_input(gen, k, ZOO_LOSS_SHAPE) for k in kinds]
        sw = gen.uniform(0.5, 1.5, (ZOO_LOSS_SHAPE[0],) + (
            () if name == "TripletLoss" else (1,))).astype(np.float32)
        wrt = [i for i, k in enumerate(kinds) if k in ("pred", "prob")]
        losses[name] = _zoo_block_case(
            mx, lambda: getattr(gluon.loss, name)(**kwargs),
            arrays + [sw], wrt, gen)
        check(losses[name] <= 1.0, "loss %s on the card vs the host: %.3g "
              "of its limit" % (name, losses[name]))
    ctc = _zoo_ctc(mx, gen)
    log(json.dumps({"check": "model zoo ctc_loss", **ctc}))
    check(ctc["worst_share_of_limit"] <= 1.0, "ctc_loss on the card vs "
          "the host: %.3g of its limit" % ctc["worst_share_of_limit"])
    return layers, losses, ctc


def phase_model_zoo(card_line, resnet_img_s):
    """Phase 18: the model zoo (see the module docstring)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry

    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    t_phase = time.perf_counter()
    result = {"phase": "model_zoo", "card": card_line,
              "reference_v100_published": ZOO_REFERENCE_V100,
              "resnet50_train_img_s_b32_phase7": resnet_img_s}
    seconds = result["seconds_by_part"] = {}
    _reset_all_launches()   # the main path starts here
    t0 = time.perf_counter()
    result["train"], result["served"] = _zoo_rates(mx, card_line)
    seconds["rates"] = time.perf_counter() - t0
    result["device_split"] = _zoo_device_split(mx)
    seconds["device_split"] = time.perf_counter() - t0 - sum(seconds.values())
    result["families"] = {}
    for name, side in ZOO_FAMILIES.items():
        t_family = time.perf_counter()
        row = _zoo_family(mx, name, side)
        row["seconds"] = time.perf_counter() - t_family
        result["families"][name] = row
        log(json.dumps({"check": "model zoo family", "network": name,
                        **row}))
    seconds["families"] = time.perf_counter() - t0 - sum(seconds.values())
    layers, losses, ctc = _zoo_surface(mx)
    seconds["layers_losses_ctc"] = time.perf_counter() - t0 - sum(
        seconds.values())
    launches = _all_launches()   # read just after the path
    result["launches"] = launches
    result["layers_worst_share"] = layers
    result["losses_worst_share"] = losses
    result["ctc_loss"] = ctc
    ops = {registry.get(n).name for n in ZOO_OPS}
    ran = {registry.get(n).name for n in ctc["operators_called"]}
    result["canonical_ops"] = {"registered": sorted(ops), "ran": sorted(ran)}
    result["seconds"] = time.perf_counter() - t_phase
    log(json.dumps(result))
    check(ran == ops, "phase 18: operators not run %s, run but not "
          "registered by the slice %s" % (sorted(ops - ran),
                                          sorted(ran - ops)))
    check(len(layers) == 24 and len(losses) == 8,
          "%d layers and %d losses run" % (len(layers), len(losses)))
    for name, row in result["families"].items():
        for part, err in row["f64_rel_l2"].items():
            check(err <= ZOO_F64_REL_L2, "%s: float64 %s on the card vs the "
                  "host: relative L2 %.3g" % (name, part, err))
        check(row["hybrid_vs_imperative_rel"] <= 1e-6, "%s: hybridized "
              "forward differs from the imperative one by %.3g"
              % (name, row["hybrid_vs_imperative_rel"]))
    for key, row in result["train"].items():
        for tag in ("fp32", "bf16"):
            check(row[tag]["img_s"] > 0, "%s %s img/s" % (key, tag))
    return result



# -- phase 19: distribution ----------------------------------------------------

DIST_ATTN = {"units": 1024, "heads": 16, "batch": 8, "seq": 2048, "steps": 5,
             "det_steps": 2, "opt": {"learning_rate": 10.0, "momentum": 0.9}}
# SGD at the linear-scaling rate of the global batch (0.1 per 256 images,
# Goyal et al.; 2 x 32 = 64). At phase 11's lr 0.1 this random-label batch
# of 64 diverged; `_dist_plain_witness` trains the same batch from the
# same weights in plain PyTorch at that rate and at `WITNESS_RATES`.
DIST_RESNET = {"batch": 32, "image": 224, "warmup": 2, "steps": 4,
               "module_batches": 2, "opt": {"learning_rate": 0.025, "momentum": 0.9, "wd": 1e-4}}
# The plain witness's rates: part 3's, half and twice it (a worker's
# gradient counted twice or half as often would follow one of those),
# and phase 11's.
WITNESS_RATES = (0.0125, 0.025, 0.05, 0.1)
DIST_TIMEOUT = 300      # seconds a part's ranks may run


def _dist_result(payload):
    """A rank's result: one line its launcher parses."""
    print("DIST_RESULT " + json.dumps(payload), flush=True)


def _dist_attention(mx):
    """The attention layer of PERF.md §4 on gpu(0), from SEED, and its
    fixed batch (numpy)."""
    from mxnet_tpu_torch.examples.attention_layer import SelfAttention

    c = DIST_ATTN
    mx.random.seed(SEED)
    net = SelfAttention(c["units"], heads=c["heads"])
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    rng = np.random.default_rng(SEED)
    shape = (c["batch"], c["seq"], c["units"])
    x = rng.standard_normal(shape, dtype=np.float32)
    y = rng.standard_normal(shape, dtype=np.float32)
    return net, x, y


def _dist_steps(step, x, y, steps):
    """(losses, step ms): each step's loss read on the host."""
    xs, ys = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    losses, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(xs, ys)))
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def _dist_state(step, net):
    from mxnet_tpu_torch.gluon.utils import relative_names

    params = step.state_to_host()[0]
    rel = relative_names(list(params), net.prefix)
    return {rel[n]: v for n, v in params.items()}


def _dist_part_nccl1(outdir):
    """Part 1, one rank: NCCL at world size 1. The dp TrainStep over a
    mesh of the group's one rank against today's single-device step."""
    import os

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import TrainStep, dist, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(dist.initialize(backend="nccl"), "no NCCL group was formed")
    check(dist.backend() == "nccl" and dist.num_processes() == 1,
          "group %s of %d" % (dist.backend(), dist.num_processes()))
    c = DIST_ATTN
    out = {"part": "nccl_world_size_1"}
    runs = {}
    for tag, mesh in (("dp", make_mesh({"dp": 1})),
                      ("single", make_mesh({"dp": 1},
                                           devices=[mx.gpu(0)]))):
        net, x, y = _dist_attention(mx)
        step = TrainStep(net, gluon.loss.L2Loss(), "sgd", dict(c["opt"]),
                         mesh=mesh)
        check((step._dp_group is not None) == (tag == "dp"),
              "%s step: dp group %r" % (tag, step._dp_group))
        _reset_launches()       # this run's path starts here
        losses, ms = _dist_steps(step, x, y, c["steps"])
        launches = _launches()  # read just after it
        runs[tag] = (losses, _dist_state(step, net))
        out[tag] = {"losses": losses, "step_ms": ms,
                    "step_ms_median": float(np.median(ms[1:])),
                    "launches": launches}
    same = runs["dp"][0] == runs["single"][0] and all(
        np.array_equal(runs["dp"][1][k], v)
        for k, v in runs["single"][1].items())
    out["bit_for_bit"] = bool(same)
    np.savez(os.path.join(outdir, "single.npz"),
             losses=np.array(runs["single"][0]),
             **{"p:" + k: v for k, v in runs["single"][1].items()})
    _dist_result(out)
    check(same, "the dp step at world size 1 is not the single-device "
          "step bit for bit")


def _dist_part_gloo2(outdir):
    """Part 2, two ranks on the one card over gloo: the dp TrainStep,
    4 rows a rank of part 1's batch of 8; then deterministic_reduction."""
    import os

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import TrainStep, dist, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(dist.initialize(backend="gloo", platform="gpu"),
          "no gloo group was formed")
    r = dist.rank()
    c = DIST_ATTN
    lo, hi = dist.local_slice(c["batch"])
    out = {"part": "gloo_two_ranks_one_card", "rank": r}
    for tag, kw, steps in (("dp", {}, c["steps"]),
                           ("det", {"deterministic_reduction": True},
                            c["det_steps"])):
        net, x, y = _dist_attention(mx)
        step = TrainStep(net, gluon.loss.L2Loss(), "sgd", dict(c["opt"]),
                         mesh=make_mesh({"dp": -1}), **kw)
        _reset_launches()       # this run's path starts here
        losses, ms = _dist_steps(step, x[lo:hi], y[lo:hi], steps)
        launches = _launches()  # read just after it
        state = _dist_state(step, net)
        np.savez(os.path.join(outdir, "%s_r%d.npz" % (tag, r)),
                 losses=np.array(losses),
                 **{"p:" + k: v for k, v in state.items()})
        out[tag] = {"losses": losses, "step_ms": ms,
                    "step_ms_median": float(np.median(ms[1:])),
                    "launches": launches}
    out["gloo_on_cuda"] = _gloo_cuda_probe()
    out["ring"] = _dist_ring_on_card(mx)
    _dist_result(out)


def _gloo_cuda_probe():
    """Which collectives this gloo group takes on CUDA tensors: each op
    once on a small tensor of the card, "ok" or the error's first line
    (an op that raises on one rank raises on both: they meet at the
    barrier after it)."""
    import torch.distributed as tdist

    r, n = tdist.get_rank(), tdist.get_world_size()
    t = torch.full((4,), float(r + 1), device="cuda")
    ops = {
        "all_reduce": lambda: tdist.all_reduce(t.clone()),
        "broadcast": lambda: tdist.broadcast(t.clone(), src=0),
        "all_gather": lambda: tdist.all_gather(
            [torch.empty_like(t) for _ in range(n)], t),
        "reduce_scatter": lambda: tdist.reduce_scatter(
            torch.empty_like(t), [t.clone() for _ in range(n)]),
    }
    # Not probed: point-to-point send/recv of a CUDA tensor, which
    # aborted the process on this machine (gloo::IoException, writev:
    # Bad address); ring attention stages its blocks through the host.
    got = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            got[name] = "ok"
        except Exception as exc:   # noqa: BLE001 — the reading itself
            got[name] = "%s: %s" % (type(exc).__name__,
                                    str(exc).splitlines()[0][:160])
        # A refused op may leave the peers at different points: meet.
        tdist.barrier()
    return got


def _dist_ring_on_card(mx):
    """ring_self_attention over the two ranks' sp mesh on CUDA q/k/v
    (B 1, H 16, T 2048, D 64, causal): forward and gradients against
    blockwise_attention on one rank; the gloo route stages each block
    through the host and counts it."""
    import importlib

    from mxnet_tpu_torch.parallel import make_mesh

    ra = importlib.import_module("mxnet_tpu_torch.parallel.ring_attention")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn((1, 16, 2048, 64), generator=gen, device="cuda")
               .requires_grad_(True) for _ in range(3))
    mesh = make_mesh({"sp": -1})
    staged0 = ra.HOST_STAGED
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ra.ring_self_attention(mesh, q, k, v, causal=True)
    grads = torch.autograd.grad((out ** 2).mean(), (q, k, v))
    torch.cuda.synchronize()
    ring_ms = (time.perf_counter() - t0) * 1e3
    want = ra.blockwise_attention(q, k, v, block=256, causal=True)
    wgrads = torch.autograd.grad((want ** 2).mean(), (q, k, v))
    err = max(float(((a - b).abs() / (2e-5 + 2e-4 * b.abs())).max())
              for a, b in [(out, want)] + list(zip(grads, wgrads)))
    check(err <= 1.0, "ring attention on the card: %.3g of the tolerance"
          % err)
    return {"shape": [1, 16, 2048, 64], "ms_forward_backward": ring_ms,
            "share_of_tolerance": err,
            "host_staged_messages": ra.HOST_STAGED - staged0}


def _dist_part_kvstore(outdir, lr=None):
    """Part 3, a worker of `-n 2 -s 1`: ResNet-50 v1 b32 (fp32, TF32
    off) through gluon.Trainer(kvstore="dist_sync"); then Module.fit
    over the exported net in the same group. `lr` replaces the SGD
    rate (`probe_dist_rate`)."""
    import hashlib
    import os

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = DIST_RESNET
    opt = dict(c["opt"], **({"learning_rate": lr} if lr else {}))
    kv = mx.kv.create("dist_sync")
    r, nw = kv.rank, kv.num_workers
    net = _resnet50()
    if r == 0:
        # The weights the store starts from, for the plain witness.
        np.savez(os.path.join(outdir, "resnet_init.npz"), *[
            p.data()._data.detach().cpu().numpy() for p in _trainable(net)])
    rng = np.random.RandomState(SEED + r)
    px = c["image"]
    x = mx.nd.array(rng.rand(c["batch"], 3, px, px).astype(np.float32),
                    ctx=mx.gpu(0))
    y = mx.nd.array(rng.randint(0, 1000, c["batch"]).astype(np.float32),
                    ctx=mx.gpu(0))
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(opt),
                            kvstore=kv)
    wire, restore = _time_wire(kv)

    def digest(n):
        # The pulled weights: the trainable parameters. BatchNorm's
        # running statistics stay each worker's own, as in the
        # reference's dist training.
        h = hashlib.sha256()
        for p in _trainable(n):
            h.update(p.data()._data.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    losses, digests, step_s, apply_s = [], [], [], []
    for i in range(c["warmup"] + c["steps"]):
        if i == c["warmup"]:
            for k in ("push_s", "pull_s", "push_bytes"):
                wire[k] = 0
        a0 = sum(s["apply_seconds"] for s in kv.server_stats())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = _record_and_backward(net, x, y)
        trainer.step(c["batch"] * nw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses.append(float(loss.mean().asnumpy()))
        digests.append(digest(net))
        if i >= c["warmup"]:
            step_s.append(dt)
            apply_s.append(sum(s["apply_seconds"]
                               for s in kv.server_stats()) - a0)
    check(trainer._update_on_kvstore and trainer._uokv_bucketed,
          "the dist Trainer did not update on the store's buckets")
    n = c["steps"]
    out = {"part": "dist_sync_trainer", "rank": r,
           "img_s": c["batch"] * n / sum(step_s),
           "step_ms": [s * 1e3 for s in step_s],
           "push_ms_per_step": wire["push_s"] * 1e3 / n,
           "pull_ms_per_step": wire["pull_s"] * 1e3 / n,
           "server_apply_ms_per_step": float(np.mean(apply_s)) * 1e3,
           "push_mb_per_step": wire["push_bytes"] / n / 1e6,
           "losses": losses, "digests": digests,
           "buckets": len(trainer._bucketer)}
    # Module.fit over the exported net, in the same group.
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        sym, arg, aux = _module_symbol(net, td)
        mod = mx.mod.Module(sym, context=mx.gpu(0))
        b = c["batch"]
        it = mx.io.NDArrayIter(
            rng.rand(b * c["module_batches"], 3, px, px).astype(
                np.float32),
            rng.randint(0, 1000, b * c["module_batches"]).astype(
                np.float32), batch_size=b, label_name="softmax_label",
            ctx=mx.gpu(0))
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=1, kvstore=kv, optimizer="sgd",
                optimizer_params=dict(opt), arg_params=arg,
                aux_params=aux)
        torch.cuda.synchronize()
        out["module_fit_s"] = time.perf_counter() - t0
        check(mod._update_on_kvstore and mod._kvstore is kv,
              "Module.fit did not update on the dist store")
        h = hashlib.sha256()
        for k, v in sorted(mod.get_params()[0].items()):
            h.update(v.asnumpy().tobytes())
        out["module_digest"] = h.hexdigest()
    restore()
    _dist_result(out)
    kv.close()
    _await_role_records(outdir)


def _dist_role_record(outdir):
    """In a scheduler or server of part 3 (whose loop runs inside
    `import mxnet_tpu_torch` and exits): record at exit whether the
    process initialised CUDA. It must not have."""
    import atexit
    import os

    role = os.environ.get("DMLC_ROLE", "")
    if role not in ("scheduler", "server"):
        return
    path = os.path.join(outdir, "cuda_%s_%d.txt" % (role, os.getpid()))

    def record():
        with open(path + ".tmp", "w") as f:
            f.write(str(torch.cuda.is_initialized()))
        os.replace(path + ".tmp", path)

    atexit.register(record)


def _dist_role_records(outdir):
    """{"scheduler": [initialised, ...], "server": [...]} as recorded."""
    import glob
    import os

    got = {"scheduler": [], "server": []}
    for path in sorted(glob.glob(os.path.join(outdir, "cuda_*.txt"))):
        role = os.path.basename(path).split("_")[1]
        with open(path) as f:
            got[role].append(f.read() == "True")
    return got


def _plain_resnet50_v1(params, x):
    """ResNet-50 v1 as the model zoo builds it (stride on the 3x3),
    written in plain torch.nn.functional with train-mode BatchNorm over
    the batch (epsilon 1e-5). `params`: the gluon net's trainable
    parameters in registration order."""
    it = iter(params)

    def conv(h, stride=1, pad=0):
        return F.conv2d(h, next(it), stride=stride, padding=pad)

    def bn(h):
        gamma, beta = next(it), next(it)
        return F.batch_norm(h, None, None, gamma, beta, training=True,
                            eps=1e-5)

    h = F.max_pool2d(F.relu(bn(conv(x, 2, 3))), 3, 2, 1)
    for stage, blocks in enumerate((3, 4, 6, 3)):
        for i in range(blocks):
            stride = 2 if stage and not i else 1
            y = F.relu(bn(conv(h)))
            y = F.relu(bn(conv(y, stride, 1)))
            y = bn(conv(y))
            if not i:
                h = bn(conv(h, stride))
            h = F.relu(y + h)
    logits = F.linear(h.mean((2, 3)), next(it), next(it))
    check(next(it, None) is None, "plain ResNet-50: parameters left over")
    return logits


def _dist_plain_witness(outdir, rates):
    """Part 3's training in plain PyTorch, independent of the port: the
    two workers' batches (each its own BatchNorm statistics), the
    gradient of their summed loss over the global batch, and the SGD
    momentum update the servers run, from the weights rank 0 started
    from. Returns {rate: rank 0's losses}."""
    import os

    c, opt = DIST_RESNET, DIST_RESNET["opt"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init = np.load(os.path.join(outdir, "resnet_init.npz"))
    data = []
    for r in range(2):
        rng = np.random.RandomState(SEED + r)
        x = rng.rand(c["batch"], 3, c["image"], c["image"]).astype(
            np.float32)
        y = rng.randint(0, 1000, c["batch"])
        data.append((torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()))
    got = {}
    for lr in rates:
        ws = [torch.from_numpy(init["arr_%d" % i]).cuda().requires_grad_()
              for i in range(len(init.files))]
        moms = [torch.zeros_like(w) for w in ws]
        losses = []
        for _ in range(c["warmup"] + c["steps"]):
            total = 0.0
            for r, (x, y) in enumerate(data):
                loss = F.cross_entropy(_plain_resnet50_v1(ws, x), y,
                                       reduction="none")
                if r == 0:
                    losses.append(float(loss.detach().mean()))
                total = total + loss.sum()
            grads = torch.autograd.grad(total, ws)
            with torch.no_grad():
                for w, g, m in zip(ws, grads, moms):
                    m.mul_(opt["momentum"]).sub_(
                        lr * (g / (2 * c["batch"]) + opt["wd"] * w))
                    w.add_(m)
        got[lr] = losses
    return got





def _dist_launch(part, workers, servers, outdir, extra=()):
    """Run `part` as `workers` ranks (and a scheduler with `servers`
    servers) through the port's launcher; returns each worker's result.
    A rank that fails fails the phase."""
    import os

    from mxnet_tpu_torch.parallel.launch import launch_local

    cmd = [sys.executable, os.path.abspath(__file__), "--dist-part", part,
           "--dist-dir", outdir] + list(extra)
    codes, outs = launch_local(workers, servers, cmd, timeout=DIST_TIMEOUT,
                               capture=True)
    errs = "\n".join("--- worker %d ---\n%s" % (i, err[-4000:])
                     for i, (_, err) in enumerate(outs))
    check(codes == [0] * workers, "dist part %s: worker exit codes %s\n"
          "%s" % (part, codes, errs))
    results = []
    for so, _ in outs:
        lines = [ln[len("DIST_RESULT "):] for ln in so.splitlines()
                 if ln.startswith("DIST_RESULT ")]
        check(len(lines) == 1, "dist part %s: a worker printed %d "
              "results\n%s" % (part, len(lines), errs))
        results.append(json.loads(lines[0]))
    return results


def _dist_close(got, want, rtol, atol_frac):
    worst = 0.0
    for k, w in want.items():
        atol = atol_frac * max(float(np.abs(w).max()), 1e-6)
        worst = max(worst, float((np.abs(got[k] - w) /
                                  (atol + rtol * np.abs(w))).max()))
    return worst


def _dist_run_kvstore(outdir, card_line, t_phase):
    """Part 3: dist_sync through the parameter server, and its checks."""
    p3 = _dist_launch("kvstore", 2, 1, outdir)
    line3 = {"part": "dist_sync_trainer", "card": card_line,
             "network": "resnet50_v1", "batch_per_worker":
             DIST_RESNET["batch"], "dtype": "float32",
             "img_s_summed": sum(p["img_s"] for p in p3),
             "img_s_per_worker": [p["img_s"] for p in p3]}
    for k in ("push_ms_per_step", "pull_ms_per_step",
              "server_apply_ms_per_step", "push_mb_per_step"):
        line3[k] = [p[k] for p in p3]
    line3["buckets"] = p3[0]["buckets"]
    # Rank 0's losses (the workers' results come in launch order; a
    # rank is the scheduler's registration order).
    ported = next(p for p in p3 if p["rank"] == 0)["losses"]
    line3["losses"] = ported
    line3["module_fit_s"] = [p["module_fit_s"] for p in p3]
    same = p3[0]["digests"] == p3[1]["digests"]
    line3["workers_bit_for_bit_every_step"] = same
    line3["module_workers_bit_for_bit"] = \
        p3[0]["module_digest"] == p3[1]["module_digest"]
    roles = _dist_role_records(outdir)
    line3["cuda_initialised_in"] = roles
    t0 = time.perf_counter()
    plain = _dist_plain_witness(outdir, WITNESS_RATES)
    lr = DIST_RESNET["opt"]["learning_rate"]
    # One update from the same weights and batch: before ReLU kinks and
    # fp32 rounding (each a few percent of a ResNet-50 update) compound.
    gap1 = {str(k): abs(v[1] - ported[1]) for k, v in plain.items()}
    line3["witness"] = {
        "plain_losses": {str(k): v for k, v in plain.items()},
        "step1_abs_gap_to_rank0": gap1,
        "step1_gap_share_of_drop": gap1[str(lr)] / (plain[lr][0] -
                                                    plain[lr][1]),
        "max_abs_gap_to_rank0": {
            str(k): float(np.max(np.abs(np.subtract(v, ported))))
            for k, v in plain.items()},
        "step0_rel_err": abs(plain[lr][0] - ported[0]) / ported[0],
        "falls": {str(k): v[-1] < v[DIST_RESNET["warmup"]]
                  for k, v in plain.items()},
        "seconds": time.perf_counter() - t0}
    line3["seconds"] = time.perf_counter() - t_phase
    log(json.dumps(line3))
    check(same, "part 3: the workers' pulled weights differ")
    check(line3["module_workers_bit_for_bit"],
          "part 3: the workers' Module weights differ")
    warm = DIST_RESNET["warmup"]
    check(ported[-1] < ported[warm],
          "part 3: the loss did not fall: %s" % ported)
    check(len(roles["scheduler"]) == 1 and len(roles["server"]) == 1,
          "part 3: the scheduler and the server did not both record "
          "their CUDA state at exit: %s" % roles)
    check(not any(roles["scheduler"] + roles["server"]),
          "part 3: a scheduler or server process initialised CUDA: %s"
          % roles)
    # The same weights and batch: the first loss is one forward apart.
    check(line3["witness"]["step0_rel_err"] <= 1e-4,
          "part 3: the first loss %.7g against the plain witness's "
          "%.7g" % (ported[0], plain[lr][0]))
    # The first update is the plain one at part 3's rate, not at half or
    # twice it.
    check(min(gap1, key=gap1.get) == str(lr),
          "part 3: the first update follows the plain witness at another "
          "rate: step-1 loss gaps %s" % gap1)


def probe_dist_rate(card_line, lr):
    """Part 3 at SGD rate `lr` beside the plain witness at that rate,
    with no check that the loss falls: how the port and plain PyTorch
    train where the rate is too high for the batch. Not run by main():
    `python3 -c "import chip_smoke as c; c.probe_dist_rate(
    c.phase_device(), 0.1)"`."""
    import shutil
    import tempfile

    outdir = tempfile.mkdtemp(prefix="phase19_probe_")
    try:
        p3 = _dist_launch("kvstore", 2, 1, outdir, ["--dist-lr", repr(lr)])
        line = {"part": "dist_sync_rate_probe", "card": card_line,
                "learning_rate": lr,
                "rank0_losses": next(p for p in p3
                                     if p["rank"] == 0)["losses"],
                "plain_losses": _dist_plain_witness(outdir, (lr,))[lr],
                "workers_bit_for_bit_every_step":
                    p3[0]["digests"] == p3[1]["digests"]}
        log(json.dumps(line))
        check(line["workers_bit_for_bit_every_step"],
              "probe: the workers' pulled weights differ")
        return line
    finally:
        shutil.rmtree(outdir, ignore_errors=True)


def phase_distributed(card_line):
    """Phase 19: the ranks run in child processes of the port's
    launcher, so this process never joins a group."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    outdir = tempfile.mkdtemp(prefix="phase19_")
    try:
        # Part 1: NCCL at world size 1.
        p1 = _dist_launch("nccl1", 1, 0, outdir)[0]
        p1["card"] = card_line
        p1["dp_overhead_ms"] = p1["dp"]["step_ms_median"] - \
            p1["single"]["step_ms_median"]
        log(json.dumps(p1))
        check(p1["bit_for_bit"], "part 1: not bit for bit")
        check(tuple(p1["dp"]["launches"]) == (DIST_ATTN["steps"],) * 3,
              "part 1: K1/K2/K3 launches %s on the dp path, not once a "
              "step each" % (p1["dp"]["launches"],))
        # Part 2: two ranks sharing the card over gloo.
        p2 = _dist_launch("gloo2", 2, 0, outdir)
        ref = np.load(outdir + "/single.npz")
        want = {k[2:]: ref[k] for k in ref.files if k.startswith("p:")}
        st = [np.load(outdir + "/dp_r%d.npz" % r) for r in range(2)]
        det = [np.load(outdir + "/det_r%d.npz" % r) for r in range(2)]
        ranks_equal = all(np.array_equal(st[0][k], st[1][k])
                          for k in st[0].files)
        det_equal = all(np.array_equal(det[0][k], det[1][k])
                        for k in det[0].files)
        loss_err = float(np.max(np.abs(st[0]["losses"] - ref["losses"]) /
                                (1e-6 + 1e-5 * np.abs(ref["losses"]))))
        state_share = _dist_close({k[2:]: st[0][k] for k in st[0].files
                                   if k.startswith("p:")}, want, 1e-5, 1e-4)
        line2 = {"part": "gloo_two_ranks_one_card", "card": card_line,
                 "step_ms_median_per_rank": [p["dp"]["step_ms_median"]
                                             for p in p2],
                 "step_ms_vs_part1_dp": p2[0]["dp"]["step_ms_median"] /
                 p1["dp"]["step_ms_median"],
                 "launches_per_rank": [p["dp"]["launches"] for p in p2],
                 "det_launches_per_rank": [p["det"]["launches"] for p in p2],
                 "losses": p2[0]["dp"]["losses"],
                 "loss_share_of_tolerance": loss_err,
                 "state_share_of_tolerance": state_share,
                 "ranks_bit_for_bit": ranks_equal,
                 "deterministic_ranks_bit_for_bit": det_equal,
                 "deterministic_losses": p2[0]["det"]["losses"],
                 "gloo_on_cuda_per_rank": [p["gloo_on_cuda"] for p in p2],
                 "ring_attention_per_rank": [p["ring"] for p in p2]}
        log(json.dumps(line2))
        check(ranks_equal, "part 2: the two ranks' weights differ")
        check(loss_err <= 1.0 and state_share <= 1.0,
              "part 2 against part 1's single-device run: loss %.3g, state "
              "%.3g of the tolerance" % (loss_err, state_share))
        for p in p2:
            check(tuple(p["dp"]["launches"]) == (DIST_ATTN["steps"],) * 3,
                  "part 2: K1/K2/K3 launches %s per rank"
                  % (p["dp"]["launches"],))
            check(p["gloo_on_cuda"]["all_reduce"] == "ok",
                  "part 2: gloo refused all_reduce on CUDA tensors")
            check(p["ring"]["host_staged_messages"] > 0,
                  "part 2: the gloo ring did not stage through the host")
        # Part 3: dist_sync through the parameter server.
        _dist_run_kvstore(outdir, card_line, t_phase)
        return {"k1_k2_k3_nccl1": p1["dp"]["launches"],
                "k1_k2_k3_gloo2": [sum(x) for x in zip(
                    *[p["dp"]["launches"] for p in p2]
                    + [p["det"]["launches"] for p in p2])]}
    finally:
        shutil.rmtree(outdir, ignore_errors=True)



# -- phase 20: detection -------------------------------------------------------

# SSD300-VGG16 as a measurement configuration of this script (not a model
# of the package). Source: SSD300 in Liu et al., "SSD: Single Shot
# MultiBox Detector" (arXiv:1512.02325), as the reference's example/ssd
# builds it (symbol_factory.py, vgg16_reduced at 300; train.py defaults):
# VGG-16 conv1_1-conv5_3 with pool3 in the "full" (ceil) convention
# (75 -> 38), pool5 3x3 stride 1 pad 1, fc6 a 3x3 conv of 1024 with
# dilation 6 and pad 6, fc7 a 1x1 conv of 1024; L2Normalization (channel)
# on relu4_3 with a learned scale initialised to 20; the extra layers a
# 1x1 conv to n/2 then a 3x3 conv to n, n = 512, 256, 256, 256 with
# strides 2, 2, 1, 1 and pads 1, 1, 0, 0; feature maps 38, 19, 10, 5, 3,
# 1; 8 732 anchors; 21 classes (VOC's 20 and the background).
SSD300 = {
    "side": 300, "classes": 21, "batch": 32,
    "vgg": ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512)),
    "extras": ((512, 2, 1), (256, 2, 1), (256, 1, 0), (256, 1, 0)),
    "sizes": ((.1, .141), (.2, .272), (.37, .447), (.54, .619),
              (.71, .79), (.88, .961)),
    "ratios": ((1, 2, .5), (1, 2, .5, 3, 1 / 3), (1, 2, .5, 3, 1 / 3),
               (1, 2, .5, 3, 1 / 3), (1, 2, .5), (1, 2, .5)),
    "steps": (8, 16, 32, 64, 100, 300),
    "anchors": 8732,
    "target": {"overlap_threshold": .5, "negative_mining_ratio": 3,
               "negative_mining_thresh": .5, "ignore_label": -1,
               "variances": (.1, .1, .2, .2)},
    "detect": {"nms_threshold": .45, "nms_topk": 400},
    "opt": {"learning_rate": 0.004, "momentum": 0.9, "wd": 5e-4},
    "warmup": 3, "windows": 5, "iters": 8, "profile_iters": 2,
    "f64_batch": 2, "dist_warmup": 2, "dist_steps": 2,
    # Part 1 holds the loss against the targets frozen after the warmup,
    # at the ends of the last two timed windows (their mean), this far
    # below its value before the windows. A step's own loss is not one
    # objective (mining takes the negatives scored worst just then), and
    # both it and the frozen one rise 15-20% for ~5-8 steps where momentum
    # overshoots (probe_ssd_loss): one window's mean rose 5% above the
    # first's in a run that learned. Over 40 steps the frozen loss fell
    # 25-33% in five runs, fp32 and bf16 (one H100 at 700 W).
    "loss_drop": 0.05,
    # Part 4: rank 0's losses against the in-process witness training the
    # two workers' batches on their mean gradient (relative).
    "dist_witness_rtol": 1e-3,
}
# Faster R-CNN's and R-FCN's and FlowNetC's widths for the op sweep: a
# 600x1000 image at stride 16 (a 38x63 map of 512 channels), 300 ROIs,
# the JAX Proposal defaults (12 anchors, pre-NMS 6 000, post-NMS 300),
# R-FCN's deformable PS-ROI (21 outputs, group and pooled 7, 4 samples a
# part, trans_std 0.1), FlowNetC's correlation (k 1, max displacement
# 20, stride2 2, pad 20, 256 channels at 48x64).
RCNN_MAP = (1, 512, 38, 63)
FLOWNET = (1, 256, 48, 64)
RCNN_IMAGE = (600.0, 1000.0)
RCNN_ROIS = 300
# D2's backward against its plain version: atomics add a pixel's bins
# in no fixed order (fp32: rtol, atol as a share of max |want|).
D2_BWD_TOL = (1e-5, 1e-6)
# Operations of one IoU test of D1 (min, max, subtractions, clamps,
# products, the union, the division and the comparison), counted once
# for every pair this run's data needs: a kept box against every later
# box of its image.
D1_OPS_PER_PAIR = 20
# The registry names of mxnet_tpu/ops/detection_ops.py (19) and
# rcnn_ops.py (14), aliases included.
DETECTION_NAMES = (
    "_contrib_MultiBoxPrior", "_contrib_multibox_prior", "MultiBoxPrior",
    "_contrib_bipartite_matching",
    "_contrib_MultiBoxTarget", "_contrib_multibox_target", "MultiBoxTarget",
    "_contrib_box_nms", "_contrib_box_non_maximum_suppression", "box_nms",
    "_contrib_box_iou", "box_iou",
    "_contrib_MultiBoxDetection", "_contrib_multibox_detection",
    "MultiBoxDetection",
    "ROIPooling", "roi_pooling", "_contrib_ROIAlign", "_contrib_roi_align",
    "_contrib_Proposal", "Proposal", "_contrib_proposal",
    "_contrib_MultiProposal", "MultiProposal", "_contrib_multi_proposal",
    "_contrib_DeformableConvolution", "DeformableConvolution",
    "_contrib_deformable_convolution",
    "_contrib_DeformablePSROIPooling", "DeformablePSROIPooling",
    "_contrib_deformable_psroi_pooling",
    "Correlation", "_contrib_Correlation")


def _ssd300(mx, ctx, seed=SEED):
    """SSD300-VGG16 (SSD300 above) from the port's gluon layers,
    initialized on `ctx` from `seed` (Xavier; the L2 scale 20)."""
    from mxnet_tpu_torch import autograd, gluon, nd

    nn = gluon.nn
    c = SSD300

    class L2Scale(gluon.HybridBlock):
        def __init__(self, channels, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.scale = self.params.get(
                    "scale", shape=(1, channels, 1, 1),
                    init=mx.init.Constant(20.0))

        def hybrid_forward(self, F, x, scale):
            return F.broadcast_mul(F.L2Normalization(x, mode="channel"),
                                   scale)

    def convs(seq, n, ch):
        for _ in range(n):
            seq.add(nn.Conv2D(ch, 3, padding=1, activation="relu"))

    class SSD(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.to_conv4 = nn.HybridSequential()
                for i, (n, ch) in enumerate(c["vgg"][:4]):
                    convs(self.to_conv4, n, ch)
                    if i < 3:
                        self.to_conv4.add(nn.MaxPool2D(2, 2,
                                                       ceil_mode=i == 2))
                self.norm4 = L2Scale(512)
                self.to_fc7 = nn.HybridSequential()
                self.to_fc7.add(nn.MaxPool2D(2, 2))
                convs(self.to_fc7, *c["vgg"][4])
                self.to_fc7.add(
                    nn.MaxPool2D(3, 1, padding=1),
                    nn.Conv2D(1024, 3, padding=6, dilation=6,
                              activation="relu"),
                    nn.Conv2D(1024, 1, activation="relu"))
                self.extras = nn.HybridSequential()
                for ch, stride, pad in c["extras"]:
                    block = nn.HybridSequential()
                    block.add(nn.Conv2D(ch // 2, 1, activation="relu"),
                              nn.Conv2D(ch, 3, strides=stride, padding=pad,
                                        activation="relu"))
                    self.extras.add(block)
                self.cls_heads = nn.HybridSequential()
                self.loc_heads = nn.HybridSequential()
                for sizes, ratios in zip(c["sizes"], c["ratios"]):
                    a = len(sizes) + len(ratios) - 1
                    self.cls_heads.add(nn.Conv2D(a * c["classes"], 3,
                                                 padding=1))
                    self.loc_heads.add(nn.Conv2D(a * 4, 3, padding=1))

        def hybrid_forward(self, F, x):
            x = self.to_conv4(x)
            sources = [self.norm4(x)]
            x = self.to_fc7(x)
            sources.append(x)
            for block in self.extras:
                x = block(x)
                sources.append(x)
            anchors, cls_preds, loc_preds = [], [], []
            b = sources[0].shape[0]
            for i, s in enumerate(sources):
                step = c["steps"][i] / c["side"]
                anchors.append(F.contrib.MultiBoxPrior(
                    s, sizes=c["sizes"][i], ratios=c["ratios"][i],
                    steps=(step, step)))
                cls_preds.append(self.cls_heads[i](s).transpose(
                    (0, 2, 3, 1)).reshape((b, -1, c["classes"])))
                loc_preds.append(self.loc_heads[i](s).transpose(
                    (0, 2, 3, 1)).reshape((b, -1)))
            return (F.concat(*anchors, dim=1), F.concat(*cls_preds, dim=1),
                    F.concat(*loc_preds, dim=1))

    mx.random.seed(seed)
    net = SSD()
    net.initialize(mx.init.Xavier(), ctx=ctx)
    with autograd.pause():
        anchors, _, _ = net(nd.zeros((1, 3, c["side"], c["side"]), ctx=ctx))
    check(anchors.shape == (1, c["anchors"], 4),
          "SSD300 anchors %s" % (anchors.shape,))
    return net


def _ssd_scenes(batch, seed):
    """Synthetic 300x300 RGB noise scenes with 1-4 boxes of random VOC
    classes, each box a flat color of its class: (x (B, 3, 300, 300),
    label (B, 4, 5) [class, x1, y1, x2, y2] padded with -1)."""
    side = SSD300["side"]
    rng = np.random.default_rng(seed)
    x = rng.random((batch, 3, side, side), dtype=np.float32) * 0.3
    y = -np.ones((batch, 4, 5), np.float32)
    for i in range(batch):
        for k in range(int(rng.integers(1, 5))):
            cls = int(rng.integers(0, SSD300["classes"] - 1))
            w, h = rng.uniform(0.1, 0.6, 2)
            x1, y1 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
            y[i, k] = [cls, x1, y1, x1 + w, y1 + h]
            r0, r1 = int(y1 * side), int((y1 + h) * side)
            c0, c1 = int(x1 * side), int((x1 + w) * side)
            x[i, :, r0:r1, c0:c1] += np.array(
                [(cls % 3) / 2, (cls // 3 % 3) / 2, (cls // 9) / 2],
                np.float32)[:, None, None]
    return x, y


def _ssd_targets(anchors, cls_preds, y):
    """MultiBoxTarget (SSD300["target"]) outside the graph: (box targets,
    box mask, class targets; -1 ignored). Hard-negative mining picks the
    negatives from `cls_preds`, so the targets move as the net learns."""
    from mxnet_tpu_torch import autograd, nd

    with autograd.pause():
        return nd.contrib.MultiBoxTarget(
            anchors, y, cls_preds.transpose((0, 2, 1)), **SSD300["target"])


def _ssd_loss_terms(cls_preds, loc_preds, targets):
    """(cross-entropy sum, smooth-L1 sum, non-ignored anchors)."""
    from mxnet_tpu_torch import nd

    box_t, box_m, cls_t = targets
    valid = cls_t >= 0      # at least the matched anchors: every box has one
    logp = nd.log_softmax(cls_preds, axis=-1)
    ce = -nd.pick(logp, nd.relu(cls_t), axis=-1) * valid
    loc = nd.smooth_l1((loc_preds - box_t) * box_m, scalar=1.0)
    return ce.sum(), loc.sum(), valid.sum()


def _ssd_loss(mx, anchors, cls_preds, loc_preds, y, targets=None):
    """Softmax cross-entropy over the non-ignored anchors plus smooth-L1
    (sigma 1) on the matched boxes' offsets, both over the count of
    non-ignored anchors; against `targets`, else this forward's
    (:func:`_ssd_targets`)."""
    if targets is None:
        targets = _ssd_targets(anchors, cls_preds, y)
    ce, loc, valid = _ssd_loss_terms(cls_preds, loc_preds, targets)
    return (ce + loc) / valid


def _ssd_eval(mx, net, x, y, targets=None, bf16=False):
    """The loss of a forward outside autograd against `targets` (this
    forward's own when None): (loss, the targets). Fixed targets make
    the loss one objective from step to step; a step's own are not,
    since mining picks the negatives the net scores worst just then."""
    from mxnet_tpu_torch import autograd

    with autograd.pause():
        anchors, cls_preds, loc_preds = net(x)
        if bf16:
            cls_preds = cls_preds.astype("float32")
            loc_preds = loc_preds.astype("float32")
        if targets is None:
            targets = _ssd_targets(anchors, cls_preds, y)
        loss = _ssd_loss(mx, anchors, cls_preds, loc_preds, y, targets)
    return float(loss.asnumpy().ravel()[0]), targets


def _ssd_step(mx, net, trainer, x, y, bf16=False, workers=1):
    """One step; the loss is a mean already, so the update takes the
    mean of the `workers`' gradients."""
    from mxnet_tpu_torch import autograd

    with autograd.record():
        anchors, cls_preds, loc_preds = net(x)
        if bf16:
            cls_preds = cls_preds.astype("float32")
            loc_preds = loc_preds.astype("float32")
        loss = _ssd_loss(mx, anchors, cls_preds, loc_preds, y)
    loss.backward()
    trainer.step(workers)
    return loss


def _ssd_rates(mx, card_line):
    """Part 1: train img/s at b32 through gluon.Trainer (fp32 with TF32
    off, bf16 over fp32 masters): warmup steps, then the median of
    windows each closed by a host readback; one torch.profiler line a
    dtype."""
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.profile_serving import _profile

    c = SSD300
    xs, ys = _ssd_scenes(c["batch"], SEED)
    y = nd.array(ys, ctx=mx.gpu(0))
    out = {}
    for tag, dtype in (("fp32", None), ("bf16", "bfloat16")):
        net = _ssd300(mx, mx.gpu(0))
        if dtype:
            net.cast(dtype)
        x = nd.array(xs, ctx=mx.gpu(0), dtype=dtype or "float32")
        trainer = gluon.Trainer(net.collect_params(), "sgd", dict(
            c["opt"], multi_precision=dtype is not None))

        def step():
            return _ssd_step(mx, net, trainer, x, y, dtype is not None)

        loss = step()
        initial = float(loss.asnumpy().ravel()[0])  # before any update
        for _ in range(c["warmup"] - 1):
            loss = step()
        first = float(loss.asnumpy().ravel()[0])
        # One objective across the windows: the targets (matches and the
        # mined negatives) of the weights after the warmup, held fixed.
        frozen_start, frozen = _ssd_eval(mx, net, x, y, bf16=dtype is not None)
        rates, means, frozen_ends = [], [], []
        for _ in range(c["windows"]):
            t0 = time.perf_counter()
            held = [step().detach() for _ in range(c["iters"])]
            last = float(held[-1].asnumpy().ravel()[0])   # closes the window
            rates.append(c["batch"] * c["iters"] /
                         (time.perf_counter() - t0))
            means.append(float(np.mean([l.asnumpy().ravel()[0]
                                        for l in held])))
            frozen_ends.append(_ssd_eval(mx, net, x, y, frozen,
                                         dtype is not None)[0])
        check(np.all(np.isfinite(means)) and last < initial and
              np.mean(frozen_ends[-2:]) <= (1 - c["loss_drop"]) *
              frozen_start,
              "SSD300 %s: the loss against the targets frozen after the "
              "warmup did not fall by %g over the timed windows: %r, then "
              "after each window %s; first step %r, window means %s"
              % (tag, c["loss_drop"], frozen_start, frozen_ends, initial,
                 means))
        prof = _profile("ssd300 train %s b%d" % (tag, c["batch"]), step,
                        iters=c["profile_iters"])
        out[tag] = {"img_s": sorted(rates)[len(rates) // 2],
                    "img_s_windows": rates,
                    "ms_per_step": c["batch"] * 1e3 /
                    sorted(rates)[len(rates) // 2],
                    "loss_first_step": initial,
                    "loss_after_warmup": first, "loss_last": last,
                    "loss_window_means": means,
                    "loss_frozen_targets": [frozen_start] + frozen_ends,
                    "device_ms": prof["device_ms"],
                    "idle_share": prof["idle_share"],
                    "top_kernels": prof["top_kernels"][:3],
                    "card": card_line}
        log(json.dumps({"check": "ssd300 train", "dtype": tag, **out[tag]}))
        del net, trainer
        torch.cuda.empty_cache()
    return out


def probe_ssd_loss(card_line, steps=24, deterministic=False, bf16=False):
    """Part 1's fp32 (or bf16) training at b32, step by step, with no
    check: each step's loss, its cross-entropy and smooth-L1 sums, the
    matched and the mined anchors, and the loss of the same weights
    against the targets frozen after the warmup. With `deterministic`,
    cuDNN's deterministic algorithms without autotuning. Not run by
    main(): `python3 -c "import chip_smoke as c; c.phase_build();
    c.probe_ssd_loss(c.phase_device(), deterministic=True)"`."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd

    c = SSD300
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = deterministic
    if deterministic:
        torch.backends.cudnn.benchmark = False
    try:
        xs, ys = _ssd_scenes(c["batch"], SEED)
        dtype = "bfloat16" if bf16 else None
        net = _ssd300(mx, mx.gpu(0))
        if dtype:
            net.cast(dtype)
        x = nd.array(xs, ctx=mx.gpu(0), dtype=dtype or "float32")
        y = nd.array(ys, ctx=mx.gpu(0))
        trainer = gluon.Trainer(net.collect_params(), "sgd", dict(
            c["opt"], multi_precision=bf16))
        frozen, rows = None, []
        for i in range(c["warmup"] + steps):
            if i == c["warmup"]:
                _, frozen = _ssd_eval(mx, net, x, y, bf16=bf16)
            fixed = _ssd_eval(mx, net, x, y, frozen, bf16)[0] \
                if frozen is not None else None
            with autograd.record():
                anchors, cls_preds, loc_preds = net(x)
                if bf16:
                    cls_preds = cls_preds.astype("float32")
                    loc_preds = loc_preds.astype("float32")
                targets = _ssd_targets(anchors, cls_preds, y)
                ce, loc, valid = _ssd_loss_terms(cls_preds, loc_preds,
                                                 targets)
                loss = (ce + loc) / valid
            loss.backward()
            trainer.step(1)
            matched = float(targets[1].sum().asnumpy().ravel()[0]) / 4
            rows.append({
                "step": i, "loss": float(loss.asnumpy().ravel()[0]),
                "ce_sum": float(ce.asnumpy().ravel()[0]),
                "loc_sum": float(loc.asnumpy().ravel()[0]),
                "matched": matched,
                "mined": float(valid.asnumpy().ravel()[0]) - matched,
                "loss_frozen_targets": fixed})
        line = {"probe": "ssd300_loss", "card": card_line,
                "dtype": "bfloat16" if bf16 else "float32",
                "cudnn_deterministic": deterministic, "steps": rows}
        log(json.dumps(line))
        return line
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


def _ssd_f64_step(mx):
    """Part 2: one float64 step at b2 from the same weights on the card
    and on the host: relative L2 of the loss, the outputs and every
    gradient."""
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.gluon.utils import params_from_numpy, relative_names

    c = SSD300
    xs, ys = _ssd_scenes(c["f64_batch"], SEED + 1)
    got = {}
    weights = None
    for where, ctx in (("card", mx.gpu(0)), ("host", mx.cpu())):
        with ctx:
            net = _ssd300(mx, ctx)
            if weights is None:
                weights = {n: p.data(ctx).asnumpy()
                           for n, p in net.collect_params().items()}
                prefix = net.prefix
            else:
                params_from_numpy(net, weights, prefix=prefix)
            net.cast("float64")
            x = nd.array(xs, ctx=ctx, dtype="float64")
            y = nd.array(ys, ctx=ctx, dtype="float64")
            with autograd.record():
                anchors, cls_preds, loc_preds = net(x)
                loss = _ssd_loss(mx, anchors, cls_preds, loc_preds, y)
            loss.backward()
            rel = relative_names(list(net.collect_params().keys()),
                                 net.prefix)
            got[where] = {
                "loss": loss.asnumpy(), "cls": cls_preds.asnumpy(),
                "loc": loc_preds.asnumpy(),
                "grads": np.concatenate([
                    p.grad(ctx).asnumpy().ravel() for n, p in sorted(
                        net.collect_params().items(),
                        key=lambda kv: rel[kv[0]])])}
            del net
    errs = {k: _rel_l2({k: got["card"][k]}, {k: got["host"][k]})
            for k in ("loss", "cls", "loc", "grads")}
    for k, err in errs.items():
        check(err <= ZOO_F64_REL_L2, "SSD300 float64 %s on the card vs the "
              "host: relative L2 %.3g" % (k, err))
    return errs


class _NmsRoute:
    """Within: D1's calls go to its plain version (on the same tensors),
    and each call's arguments are kept in `calls`."""

    def __init__(self, plain=False):
        self.plain, self.calls = plain, []

    def __enter__(self):
        from mxnet_tpu_torch.ops import detection_ops as det

        self._kernel = det.nms_sorted

        def route(boxes, valid, cls_ids, thresh, iou_mode=det.IOU_CORNER,
                  quota=None):
            args = (boxes, valid, cls_ids, thresh, iou_mode, quota)
            self.calls.append(args)
            if self.plain:
                return det.nms_sorted_reference(
                    *args[:5], valid.shape[1] if quota is None else quota)
            return self._kernel(*args)

        det.nms_sorted = route
        return self

    def __exit__(self, *exc):
        from mxnet_tpu_torch.ops import detection_ops as det

        det.nms_sorted = self._kernel


def _ssd_decode(mx):
    """Part 3: MultiBoxDetection (SSD300["detect"]) over a b32 forward of
    the trained net's shape: ms, D1's launches on that path, and the
    kernel route's output equal to the plain route's on the card bit
    for bit. Returns (row, D1's inputs as the path gave them)."""
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.ops import detection_ops as det

    c = SSD300
    net = _ssd300(mx, mx.gpu(0))
    xs, _ = _ssd_scenes(c["batch"], SEED + 2)
    with autograd.pause():
        anchors, cls_preds, loc_preds = net(nd.array(xs, ctx=mx.gpu(0)))
        cls_prob = cls_preds.softmax(axis=-1).transpose((0, 2, 1))

        def decode():
            return nd.contrib.MultiBoxDetection(
                cls_prob, loc_preds, anchors, **c["detect"])

        det.NMS_LAUNCHES = 0            # the main path starts here
        with _NmsRoute() as kernel_route:
            got = decode()
            torch.cuda.synchronize()
        launches = det.NMS_LAUNCHES     # read just after it
        with _NmsRoute(plain=True):
            want = decode()
        ms = time_ms(decode, iters=10)
    same = torch.equal(got._data, want._data)
    kept = int((got._data[..., 0] >= 0).sum())
    check(same, "MultiBoxDetection: the kernel route's output differs from "
          "the plain route's on the card")
    check(launches == 1, "MultiBoxDetection launched D1 %d times" % launches)
    del net
    torch.cuda.empty_cache()
    return {"batch": c["batch"], "anchors": c["anchors"], **c["detect"],
            "ms": ms, "d1_launches": launches, "detections_kept": kept,
            "kernel_equals_plain_route": same}, kernel_route.calls[0]


def _time_wire(kv):
    """Time kv.push and kv.pull in place: returns the totals (reset them
    to start a window) and a function that restores the store."""
    wire = {"push_s": 0.0, "pull_s": 0.0, "push_bytes": 0}
    push, pull = kv.push, kv.pull

    def timed_push(key, value, priority=0):
        vals = value if isinstance(value, (list, tuple)) else [value]
        wire["push_bytes"] += vals[0].size * vals[0]._data.element_size()
        t0 = time.perf_counter()
        push(key, value, priority)
        wire["push_s"] += time.perf_counter() - t0

    def timed_pull(key, out=None, priority=0, ignore_sparse=True):
        t0 = time.perf_counter()
        pull(key, out=out, priority=priority)
        wire["pull_s"] += time.perf_counter() - t0

    def restore():
        kv.push, kv.pull = push, pull

    kv.push, kv.pull = timed_push, timed_pull
    return wire, restore


def _await_role_records(outdir):
    """In a worker, after kv.close(): wait for the scheduler's and the
    servers' records (the launcher kills every role once the workers are
    gone)."""
    import os

    deadline = time.time() + 60
    want = {"scheduler": 1, "server": int(os.environ["DMLC_NUM_SERVER"])}
    while time.time() < deadline and any(
            len(v) < want[k] for k, v in _dist_role_records(outdir).items()):
        time.sleep(0.1)


def _dist_part_ssd(outdir):
    """Phase 20 part 4, a worker of `-n 2 -s 1`: SSD300-VGG16 fp32 (TF32
    off) at b32 through gluon.Trainer(kvstore="dist_sync")."""
    import hashlib

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.ops import detection_ops as det

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = SSD300
    kv = mx.kv.create("dist_sync")
    r = kv.rank
    net = _ssd300(mx, mx.gpu(0))
    xs, ys = _ssd_scenes(c["batch"], SEED + 10 + r)
    x, y = nd.array(xs, ctx=mx.gpu(0)), nd.array(ys, ctx=mx.gpu(0))
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(c["opt"]),
                            kvstore=kv)
    wire, restore = _time_wire(kv)
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]

    def digest():
        h = hashlib.sha256()
        for p in params:
            h.update(p.data()._data.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    d0 = (det.NMS_LAUNCHES, det.ROI_POOL_LAUNCHES, det.ROI_POOL_BWD_LAUNCHES)
    losses, digests, step_s, apply_s = [], [], [], []
    for i in range(c["dist_warmup"] + c["dist_steps"]):
        if i == c["dist_warmup"]:
            wire.update(push_s=0.0, pull_s=0.0, push_bytes=0)
        a0 = sum(s["apply_seconds"] for s in kv.server_stats())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = _ssd_step(mx, net, trainer, x, y, workers=kv.num_workers)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses.append(float(loss.asnumpy().ravel()[0]))
        digests.append(digest())
        if i >= c["dist_warmup"]:
            step_s.append(dt)
            apply_s.append(sum(s["apply_seconds"]
                               for s in kv.server_stats()) - a0)
    restore()
    n = c["dist_steps"]
    _dist_result({
        "part": "dist_sync_ssd300", "rank": r,
        "img_s": c["batch"] * n / sum(step_s),
        "step_ms": [s * 1e3 for s in step_s],
        "push_ms_per_step": wire["push_s"] * 1e3 / n,
        "pull_ms_per_step": wire["pull_s"] * 1e3 / n,
        "server_apply_ms_per_step": float(np.mean(apply_s)) * 1e3,
        "push_mb_per_step": wire["push_bytes"] / n / 1e6,
        "losses": losses, "digests": digests,
        "d1_d2_launches": [a - b for a, b in zip(
            (det.NMS_LAUNCHES, det.ROI_POOL_LAUNCHES,
             det.ROI_POOL_BWD_LAUNCHES), d0)]})
    kv.close()
    _await_role_records(outdir)


def _ssd_dist_witness(steps):
    """Rank 0's losses as one process on the card gives them: both
    workers' batches from the same weights, each step on the mean of
    their losses (the mean of their gradients, which the server
    applies), through a ``gluon.Trainer`` without a store."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd

    c = SSD300
    net = _ssd300(mx, mx.gpu(0))
    batches = [[nd.array(a, ctx=mx.gpu(0))
                for a in _ssd_scenes(c["batch"], SEED + 10 + r)]
               for r in range(2)]
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(c["opt"]))
    losses = []
    for _ in range(steps):
        with autograd.record():
            per = [_ssd_loss(mx, *net(x), y) for x, y in batches]
            loss = (per[0] + per[1]) / 2
        loss.backward()
        trainer.step(1)
        losses.append(float(per[0].asnumpy().ravel()[0]))
    del net, trainer
    torch.cuda.empty_cache()
    return losses


def _ssd_dist(card_line):
    """Part 4: two workers sharing the card, one server and the scheduler
    on the host; rank 0's losses against :func:`_ssd_dist_witness`."""
    import shutil
    import tempfile

    outdir = tempfile.mkdtemp(prefix="phase20_")
    try:
        t0 = time.perf_counter()
        res = _dist_launch("ssd", 2, 1, outdir)
        roles = _dist_role_records(outdir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    rank0 = next(p for p in res if p["rank"] == 0)
    line = {"part": "dist_sync_ssd300", "card": card_line,
            "batch_per_worker": SSD300["batch"], "dtype": "float32",
            "img_s_summed": sum(p["img_s"] for p in res),
            "img_s_per_worker": [p["img_s"] for p in res],
            "losses_rank0": rank0["losses"],
            "workers_bit_for_bit_every_step":
                res[0]["digests"] == res[1]["digests"],
            "cuda_initialised_in": roles,
            "d1_d2_launches_per_worker": [p["d1_d2_launches"] for p in res],
            "seconds": time.perf_counter() - t0}
    witness = _ssd_dist_witness(len(rank0["losses"]))
    line["witness_losses"] = witness
    line["witness_max_rel_gap"] = max(
        abs(a - b) / abs(b) for a, b in zip(rank0["losses"], witness))
    for k in ("push_ms_per_step", "pull_ms_per_step",
              "server_apply_ms_per_step", "push_mb_per_step"):
        line[k] = [p[k] for p in res]
    log(json.dumps(line))
    check(line["workers_bit_for_bit_every_step"],
          "phase 20 dist_sync: the workers' pulled weights differ")
    check(all(np.isfinite(rank0["losses"])) and
          rank0["losses"][-1] < rank0["losses"][0],
          "phase 20 dist_sync: loss %s" % rank0["losses"])
    check(line["witness_max_rel_gap"] <= SSD300["dist_witness_rtol"],
          "phase 20 dist_sync: rank 0's losses %s against the in-process "
          "mean-gradient witness's %s" % (rank0["losses"], witness))
    check(len(roles["scheduler"]) == 1 and len(roles["server"]) == 1,
          "phase 20 dist_sync: the scheduler and the server did not both "
          "record their CUDA state at exit: %s" % roles)
    check(not any(roles["scheduler"] + roles["server"]),
          "phase 20 dist_sync: a scheduler or server process initialised "
          "CUDA: %s" % roles)
    return line


def _det_rois(gen, dev, n, dtype):
    """`n` ROIs [0, x1, y1, x2, y2] in a RCNN_IMAGE (height, width) image:
    corners uniform, sides 16-400 pixels."""
    h, w = RCNN_IMAGE
    wh = torch.empty((n, 2), device=dev, dtype=dtype).uniform_(
        16, 400, generator=gen)
    xy = torch.rand((n, 2), device=dev, dtype=dtype, generator=gen) * \
        (torch.tensor([w, h], device=dev, dtype=dtype) - wh)
    return torch.cat([torch.zeros((n, 1), device=dev, dtype=dtype), xy,
                      xy + wh], dim=1)


def _det_cases(mx):
    """One _Case per detection operator (13 operators, 33 names) at the
    widths of its model, in float64 on the card."""
    from mxnet_tpu_torch.ops import detection_ops as det

    f64 = torch.float64
    c = SSD300
    b, a = c["batch"], c["anchors"]
    cases = []

    def add(op, family, make, grad=None, wrt=None):
        cases.append(_Case(op, family, make, grad=grad, wrt=wrt,
                           rows=False))

    def priors(dev):
        ps = []
        for i, side in enumerate((38, 19, 10, 5, 3, 1)):
            step = c["steps"][i] / c["side"]
            ps.append(det._multibox_prior(
                torch.zeros((1, 1, side, side), device=dev),
                sizes=c["sizes"][i], ratios=c["ratios"][i],
                steps=(step, step)))
        return torch.cat(ps, dim=1).to(f64)

    def labels(gen, dev):
        _, ys = _ssd_scenes(b, SEED + 3)
        return torch.from_numpy(ys).to(dev, f64)

    def detections(gen, dev):
        """SSD's decoded boxes (B, A, 6) [cls, score, corners]."""
        probs = torch.softmax(torch.randn((b, a, c["classes"]), device=dev,
                                          dtype=f64, generator=gen) * 3, -1)
        score, cls = probs[..., 1:].max(-1)
        cx, cy = torch.rand((2, b, a), device=dev, dtype=f64, generator=gen)
        wh = torch.empty((2, b, a), device=dev, dtype=f64).uniform_(
            0.05, 0.5, generator=gen)
        return torch.stack([cls.to(f64), score, cx - wh[0] / 2,
                            cy - wh[1] / 2, cx + wh[0] / 2, cy + wh[1] / 2],
                           dim=-1)

    add("_contrib_MultiBoxPrior", "nn", lambda gen, dev: (
        [torch.zeros((1, 512, 38, 38), device=dev, dtype=f64)],
        {"sizes": c["sizes"][0], "ratios": c["ratios"][0],
         "steps": (8 / 300, 8 / 300)}))
    add("_contrib_MultiBoxTarget", "nn", lambda gen, dev: (
        [priors(dev), labels(gen, dev),
         torch.randn((b, c["classes"], a), device=dev, dtype=f64,
                     generator=gen)], dict(c["target"])))
    add("_contrib_bipartite_matching", "ordering", lambda gen, dev: (
        [det._box_iou(priors(dev)[0], labels(gen, dev)[:, :, 1:])],
        {"threshold": 1e-12}))
    add("_contrib_box_iou", "nn", lambda gen, dev: (
        [priors(dev)[0], labels(gen, dev)[:, :, 1:].reshape(-1, 4)], {}))
    add("_contrib_box_nms", "matrix", lambda gen, dev: (
        [detections(gen, dev)],
        {"overlap_thresh": c["detect"]["nms_threshold"],
         "topk": c["detect"]["nms_topk"], "valid_thresh": 0.01,
         "coord_start": 2, "score_index": 1, "id_index": 0}))
    add("_contrib_MultiBoxDetection", "nn", lambda gen, dev: (
        [torch.softmax(torch.randn((b, c["classes"], a), device=dev,
                                   dtype=f64, generator=gen) * 3, 1),
         torch.randn((b, a * 4), device=dev, dtype=f64, generator=gen)
         * 0.5, priors(dev)], dict(c["detect"])))
    feat = lambda gen, dev: torch.randn(  # noqa: E731
        RCNN_MAP, device=dev, dtype=f64, generator=gen)
    add("ROIPooling", "matrix", lambda gen, dev: (
        [feat(gen, dev), _det_rois(gen, dev, RCNN_ROIS, f64)],
        {"pooled_size": (7, 7), "spatial_scale": 1 / 16}), "head", [0])
    add("_contrib_ROIAlign", "resampling", lambda gen, dev: (
        [feat(gen, dev), _det_rois(gen, dev, RCNN_ROIS, f64)],
        {"pooled_size": (7, 7), "spatial_scale": 1 / 16,
         "sample_ratio": 2}), "head", [0])
    ch, hh, ww = RCNN_MAP[1:]

    def rpn(gen, dev, n):
        return [torch.rand((n, 24, hh, ww), device=dev, dtype=f64,
                           generator=gen),
                torch.randn((n, 48, hh, ww), device=dev, dtype=f64,
                            generator=gen) * 0.2,
                torch.tensor([[RCNN_IMAGE[0], RCNN_IMAGE[1], 1.0]] * n,
                             device=dev, dtype=f64)]

    add("_contrib_Proposal", "nn", lambda gen, dev: (
        rpn(gen, dev, 1), {"output_score": True}))
    add("_contrib_MultiProposal", "nn", lambda gen, dev: (
        rpn(gen, dev, 2), {"output_score": True}))
    add("_contrib_DeformableConvolution", "nn", lambda gen, dev: (
        [feat(gen, dev),
         torch.randn((1, 18, hh, ww), device=dev, dtype=f64,
                     generator=gen) * 2,
         torch.randn((ch, ch, 3, 3), device=dev, dtype=f64,
                     generator=gen) * 0.02,
         torch.randn((ch,), device=dev, dtype=f64, generator=gen)],
        {"kernel": (3, 3), "pad": (1, 1), "num_filter": ch}), "head")
    add("_contrib_DeformablePSROIPooling", "resampling", lambda gen, dev: (
        [torch.randn((1, 21 * 49, hh, ww), device=dev, dtype=f64,
                     generator=gen), _det_rois(gen, dev, RCNN_ROIS, f64),
         torch.randn((RCNN_ROIS, 2, 7, 7), device=dev, dtype=f64,
                     generator=gen)],
        {"spatial_scale": 1 / 16, "output_dim": 21, "group_size": 7,
         "pooled_size": 7, "part_size": 7, "sample_per_part": 4,
         "trans_std": 0.1}), "head", [0, 2])
    add("Correlation", "nn", lambda gen, dev: (
        [torch.randn(FLOWNET, device=dev, dtype=f64, generator=gen)
         for _ in range(2)],
        {"kernel_size": 1, "max_displacement": 20, "stride1": 1,
         "stride2": 2, "pad_size": 20}), "head")
    return cases


def _det_sweep(mx, dev="cuda"):
    """Part 5: each detection operator once on the card against the host
    in float64, forward and, where it has one, gradient, within
    SURFACE_TOL; every one of the 33 names resolves to one of them."""
    from mxnet_tpu_torch.ops import registry

    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst, seconds = {}, {}
    for case in _det_cases(mx):
        t0 = time.perf_counter()
        inputs, attrs = case.make(gen, dev)
        heads = []

        def card_head(shape, like):
            h = torch.empty(shape, dtype=like.dtype,
                            device=like.device).uniform_(0.5, 1.5,
                                                         generator=gen)
            heads.append(h)
            return h

        def host_head(shape, like):
            return _to_host(heads[0], like.dtype).reshape(shape)

        got = _run_case(mx, case, inputs, attrs, mx.gpu(0), card_head)
        host_in = [_to_host(t, case.host_dtype) for t in inputs]
        with mx.cpu():
            want = _run_case(mx, case, host_in, attrs, mx.cpu(), host_head)
        share = _compare_case(case, got, want, host_in, None)
        check(share <= 1.0, "detection op %s on the card vs the host: %.3g "
              "of its limit" % (case.op, share))
        worst[case.op] = share
        seconds[case.op] = time.perf_counter() - t0
        del got, want, inputs, host_in
        torch.cuda.empty_cache()
    ops = {registry.get(n).name for n in DETECTION_NAMES}
    check(set(worst) == ops and len(DETECTION_NAMES) == 33,
          "phase 20 sweep: operators %s, registered %s"
          % (sorted(worst), sorted(ops)))
    return {"names": len(DETECTION_NAMES), "operators": len(worst),
            "worst_share_of_limit": worst, "seconds": seconds}


def _nms_pairs(keep_idx, n_kept, n):
    """IoU tests the data needs: each kept box against every later box
    of its image."""
    pos = torch.arange(keep_idx.shape[1], device=keep_idx.device)
    later = (n - 1 - keep_idx).clamp_min(0)
    return int(torch.where(pos[None] < n_kept[:, None], later,
                           torch.zeros_like(later)).sum())


def _d1_row(card, calls):
    """D1 against its plain version on the card at each path's shape:
    keep, kept positions and counts bit for bit; time, plain time and
    the bound at the first shape (SSD's decode); every shape listed."""
    from mxnet_tpu_torch.ops import detection_ops as det

    shapes, row = [], None
    for tag, args in calls:
        boxes, valid, cls_ids, thresh, mode, quota = args
        b, n = valid.shape
        got = det.nms_sorted(*args)
        want = det.nms_sorted_reference(*args[:5], n if quota is None
                                        else quota)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        check(same, "D1 at %s: the keep mask differs from the plain "
              "version's" % tag)
        pairs = _nms_pairs(got[1], got[2], n)
        nbytes = sum(t.numel() * t.element_size() for t in
                     [boxes, valid] + ([cls_ids] if cls_ids is not None
                                       else []) + list(got))
        peak = PEAKS["H100" if "H100" in card else "H200"]
        bound = max(nbytes / peak["bytes"],
                    pairs * D1_OPS_PER_PAIR / peak["float32"]) * 1e3
        ms = time_ms(lambda: det.nms_sorted(*args), iters=10)
        plain_ms = time_ms(lambda: det.nms_sorted_reference(
            *args[:5], n if quota is None else quota), iters=2, warmup=1)
        shape = {"path": tag, "batch": b, "boxes": n, "quota": quota,
                 "iou": "legacy" if mode == det.IOU_LEGACY else "corner",
                 "dtype": str(boxes.dtype).split(".")[1],
                 "kept": int(got[2].sum()), "iou_pairs_needed": pairs,
                 "ms": ms, "device_ms": time_queued(
                     lambda: det.nms_sorted(*args), reps=5, iters=5),
                 "plain_ms": plain_ms, "bound_ms": bound,
                 "bound_by": "bytes" if nbytes / peak["bytes"] >
                 pairs * D1_OPS_PER_PAIR / peak["float32"] else "operations",
                 "bound_share": bound / ms, "bit_for_bit": same}
        shapes.append(shape)
        if row is None:
            row = {"name": "D1 nms_mask_kernel + nms_scan_kernel",
                   "route": "cuda",
                   "source": "mxnet_tpu_torch/csrc/detection.cu",
                   "replaces": "mxnet_tpu/ops/detection_ops.py:234 "
                               "(_nms_mask, XLA; no Pallas kernel)",
                   "max_abs_err": 0.0, "library_ms": None,
                   **{k: shape[k] for k in ("ms", "device_ms", "plain_ms",
                                            "bound_ms", "bound_by")}}
    row["shapes"] = shapes
    row["library"] = "none: torch has no NMS call"
    return row


def _d2_rows(card, dev="cuda"):
    """D2's forward and backward against their plain versions on the card
    at Faster R-CNN's ROIPooling shape (fp32): the forward and its
    argmax bit for bit, the gradient within D2_BWD_TOL; times, plain
    times and bytes bounds."""
    from mxnet_tpu_torch.ops import detection_ops as det

    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    data = torch.randn(RCNN_MAP, device=dev, generator=gen)
    rois = _det_rois(gen, dev, RCNN_ROIS, torch.float32)
    pooled, scale = (7, 7), 1 / 16
    out, am = det.roi_pool_forward(data, rois, pooled, scale)
    want, want_am = det.roi_pool_forward_reference(data, rois, pooled, scale)
    fwd_same = torch.equal(out, want) and torch.equal(am, want_am)
    check(fwd_same, "D2 forward differs from its plain version")
    grad = torch.rand(out.shape, device=dev, generator=gen)
    gk = det.roi_pool_backward(grad, am, data.shape)
    gp = det.roi_pool_backward_reference(grad, am, data.shape)
    rtol, atol_rel = D2_BWD_TOL
    share = _share(gk, gp, rtol, atol_rel)
    check(share <= 1.0, "D2 backward: %.3g of its tolerance" % share)
    peak = PEAKS["H100" if "H100" in card else "H200"]
    common = {"route": "cuda", "source": "mxnet_tpu_torch/csrc/detection.cu",
              "replaces": "mxnet_tpu/ops/detection_ops.py:376 (ROIPooling, "
                          "XLA; no Pallas kernel)",
              "library_ms": None,
              "library": "none: torch has no ROI pooling call",
              "shape": {"data": list(RCNN_MAP), "rois": RCNN_ROIS,
                        "pooled": list(pooled), "spatial_scale": scale,
                        "dtype": "float32"},
              "bound_by": "bytes"}
    fwd_bytes = sum(t.numel() * t.element_size()
                    for t in (data, rois, out, am))
    bwd_bytes = sum(t.numel() * t.element_size() for t in (grad, am, gk))
    rows = []
    for name, fn, plain, nbytes, err in (
            ("D2 roi_pool_fwd_kernel",
             lambda: det.roi_pool_forward(data, rois, pooled, scale),
             lambda: det.roi_pool_forward_reference(data, rois, pooled,
                                                    scale),
             fwd_bytes, 0.0),
            ("D2 roi_pool_bwd_kernel",
             lambda: det.roi_pool_backward(grad, am, data.shape),
             lambda: det.roi_pool_backward_reference(grad, am, data.shape),
             bwd_bytes, float((gk - gp).abs().max()))):
        ms = time_ms(fn, iters=10)
        bound = nbytes / peak["bytes"] * 1e3
        rows.append({"name": name, **common, "ms": ms,
                     "device_ms": time_queued(fn, reps=5, iters=5),
                     "plain_ms": time_ms(plain, iters=3, warmup=1),
                     "bound_ms": bound, "bound_share": bound / ms,
                     "bytes": nbytes, "max_abs_err": err})
    rows[0]["bit_for_bit"] = fwd_same
    rows[1]["tolerance"] = D2_BWD_TOL
    rows[1]["share_of_tolerance"] = share
    return rows


def _det_launches():
    from mxnet_tpu_torch.ops import detection_ops as det

    return (det.NMS_LAUNCHES, det.ROI_POOL_LAUNCHES,
            det.ROI_POOL_BWD_LAUNCHES)


def _reset_det_launches():
    from mxnet_tpu_torch.ops import detection_ops as det

    det.NMS_LAUNCHES = det.ROI_POOL_LAUNCHES = det.ROI_POOL_BWD_LAUNCHES = 0


def _proposal_nms_call(mx, dev="cuda"):
    """D1's arguments as Proposal gives them at the JAX defaults over a
    38x63 map (fp32), and its rois."""
    from mxnet_tpu_torch.ndarray.ndarray import NDArray, _invoke

    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    hh, ww = RCNN_MAP[2:]
    inputs = [torch.rand((1, 24, hh, ww), device=dev, generator=gen),
              torch.randn((1, 48, hh, ww), device=dev, generator=gen)
              * 0.2, torch.tensor([[RCNN_IMAGE[0], RCNN_IMAGE[1], 1.0]],
                                  device=dev)]
    with _NmsRoute() as route, mx.gpu(0):
        _invoke("_contrib_Proposal", [NDArray(t, ctx=mx.gpu(0))
                                      for t in inputs])
    return route.calls[0]


def phase_detection(card_line):
    """Phase 20: detection on the card (see the module docstring)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples import train_rcnn

    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    card = torch.cuda.get_device_name(0)
    t_phase = time.perf_counter()
    seconds = {}
    result = {"phase": "detection", "card": card_line,
              "config": "SSD300-VGG16, 21 classes, 8732 anchors, b32"}
    launches = {}

    def part(name, fn, path=True):
        t0 = time.perf_counter()
        if path:
            _reset_det_launches()       # the path starts here
        out = fn()
        if path:
            launches[name] = _det_launches()    # read just after it
        seconds[name] = time.perf_counter() - t0
        return out

    result["train"] = part("ssd300_train", lambda: _ssd_rates(mx, card_line))
    result["f64_rel_l2"] = part("ssd300_f64_step", lambda: _ssd_f64_step(mx))
    result["decode"], ssd_call = part("ssd300_decode",
                                      lambda: _ssd_decode(mx), path=False)
    # The decode path is its one MultiBoxDetection call, read there.
    launches["ssd300_decode"] = (result["decode"]["d1_launches"], 0, 0)
    result["dist"] = part("ssd300_dist_sync", lambda: _ssd_dist(card_line))
    result["dist_worker_launches"] = result["dist"][
        "d1_d2_launches_per_worker"]
    result["sweep"] = part("op_sweep", lambda: _det_sweep(mx))
    result["rcnn_example_rpn_losses"] = part(
        "rcnn_example", lambda: train_rcnn.run(steps=10, ctx=mx.gpu(0)))
    kernels = part("kernels", lambda: [_d1_row(card, [
        ("ssd300_decode", ssd_call),
        ("proposal_op", _proposal_nms_call(mx))])] + _d2_rows(card),
        path=False)
    result["launches"] = launches
    result["seconds_by_part"] = seconds
    result["seconds"] = time.perf_counter() - t_phase
    log(json.dumps(result))
    for row in kernels:
        log(json.dumps({"check": "detection kernel", **row}))
    check(launches["ssd300_train"] == (0, 0, 0), "SSD300 training launched "
          "D1/D2: %s" % (launches["ssd300_train"],))
    check(launches["ssd300_decode"][0] > 0, "the SSD decode path did not "
          "launch D1")
    check(launches["op_sweep"][0] > 0 and launches["op_sweep"][1] > 0 and
          launches["op_sweep"][2] > 0, "the op sweep did not launch D1 and "
          "D2: %s" % (launches["op_sweep"],))
    # The example trains its head on pooled features outside the graph,
    # as the JAX package's does: D2's backward is not on its path.
    check(launches["rcnn_example"][0] > 0 and launches["rcnn_example"][1] > 0,
          "the Faster R-CNN example did not launch D1 and D2's forward: %s"
          % (launches["rcnn_example"],))
    for row, k in zip(kernels, range(3)):
        row["launches_by_path"] = {p: n[k] for p, n in launches.items()}
        row["launches_by_path"]["ssd300_dist_sync_workers"] = sum(
            w[k] for w in result["dist_worker_launches"])
        row["launches"] = sum(row["launches_by_path"].values())
        row["card"] = card_line
    return kernels


# -- phase 21: model placement -------------------------------------------------

# ResNet-50 v1 (fp32, TF32 off, cuDNN deterministic, SGD at
# DIST_RESNET["opt"]): part 1 at {"dp": 1, "tp": 2} on one fixed batch of
# 32 for `tp_steps`; part 3 at {"dp": 2, "tp": 2} and its {"dp": 2}
# reference on global batches of 64 for `dp_steps`, then one more step
# after the sharded checkpoint; then `dp_steps` more at {"dp": 2, "tp":
# 2} under cuDNN's default algorithms, whose replicas must stay equal.
PLACE_RESNET = {"batch": 32, "tp_steps": 3, "global_batch": 64,
                "dp_steps": 2}
# Part 4: examples.model_parallel_lstm, its groups alternating the card
# and the host, at phase 16's LM widths (LM: vocabulary 10 000, embed and
# hidden 200, 2 layers, batch 32, 20 steps long): `width_steps` timed
# steps. Its data (a copy task: the next token repeats the current one,
# 10% noise) is learnt per token there: each of the 10 000 tokens has its
# own embedding row and output row, and 30 steps of 640 tokens show each
# token about twice, so the nll stays at ln(10 000) (also over 90 steps
# and at rates 0.3-1000 on the host). The example's own check (the nll
# falls over `steps`) runs at the same widths over its vocabulary of 20.
PLACE_LM = {"steps": 30, "width_steps": 5, "learn_vocab": 20}
# group2ctx's two-group symbol against one device (tests/test_executor_
# groups.py's tolerances: forward rtol, gradients rtol, atol).
PLACE_GROUPS_TOL = (1e-5, 1e-4, 1e-5)


def _place_setup():
    """Bit-for-bit comparisons across processes: fp32 without TF32 and
    cuDNN's deterministic algorithms, chosen by its heuristics. Returns
    the flags it replaced (`_place_restore`)."""
    b = torch.backends
    old = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
           b.cudnn.deterministic, b.cudnn.benchmark)
    b.cuda.matmul.allow_tf32 = False
    b.cudnn.allow_tf32 = False
    b.cudnn.deterministic = True
    b.cudnn.benchmark = False
    return old


def _place_restore(old):
    b = torch.backends
    (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
     b.cudnn.benchmark) = old


def _replica_digests(step):
    """{key: sha256} of this rank's own live state (no gather): "p:",
    "s<i>:" and "a:" keys, as tests/torch_tp_prog.py's live_arrays."""
    import hashlib

    def digest(t):
        return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                              .tobytes()).hexdigest()

    out = {}
    for n, v in step._param_vals.items():
        out["p:" + n] = digest(v)
        for i, s in enumerate(step._opt_state[n]):
            out["s%d:%s" % (i, n)] = digest(s)
    out.update({"a:" + n: digest(v) for n, v in step._aux_vals.items()})
    return out


def _replicas_apart(parts, split, tp_of):
    """The state keys whose replicas differ: a replicated one between
    any two ranks, a split block between the ranks of one tp index."""
    apart = set()
    for r, d in enumerate(parts):
        for q, e in enumerate(parts):
            apart.update(k for k in d if d[k] != e[k] and (
                k.split(":", 1)[1] not in split or tp_of[r] == tp_of[q]))
    return sorted(apart)


def _held_bytes(step):
    """Bytes of the parameters and optimizer state a TrainStep holds."""
    n = 0
    for name, v in step._param_vals.items():
        n += v.numel() * v.element_size() + sum(
            s.numel() * s.element_size() for s in step._opt_state[name])
    return n


def _place_batches(n, batch, seed):
    rng = np.random.default_rng(seed)
    return [(rng.random((batch, 3, 224, 224), dtype=np.float32),
             rng.integers(0, 1000, batch).astype(np.float32))
            for _ in range(n)]


def _place_resnet(mesh):
    """A ResNet-50 v1 TrainStep from SEED over `mesh`; the names restart,
    so every net of a process keys its state alike."""
    import mxnet_tpu_torch as mx

    _fresh_names()
    return mx.parallel.TrainStep(
        _resnet50(), mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
        dict(DIST_RESNET["opt"]), mesh=mesh)


def _on_card(x, y, rows=None):
    lo, hi = rows or (0, x.shape[0])
    return (torch.from_numpy(x[lo:hi]).cuda(),
            torch.from_numpy(y[lo:hi]).cuda())


def _timed_step(step, x, y):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(step(x, y))
    return loss, (time.perf_counter() - t0) * 1e3


def _same_state(a, b):
    """Two state_to_host() triples equal bit for bit."""
    return all(sorted(x) == sorted(y) and all(
        np.array_equal(np.asarray(x[k]), np.asarray(y[k])) for k in x)
        for x, y in zip(a, b))


def _sum_reads(reads):
    """One launch read ({"k1_k2_k3": [...], "rtc": n, ...}) summed over
    ranks."""
    out = {}
    for k, v in reads[0].items():
        if isinstance(v, list):
            out[k] = [sum(r[k][i] for r in reads) for i in range(len(v))]
        else:
            out[k] = sum(r[k] for r in reads)
    return out


def _place_part_tp2(outdir):
    """Parts 1 and 2, and part 3's {"dp": 2} reference: two ranks on the
    one card over gloo."""
    import os

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import TrainStep, dist, make_mesh

    _place_setup()
    check(dist.initialize(backend="gloo", platform="gpu"),
          "no gloo group was formed")
    r = dist.rank()
    out = {"rank": r}
    tp = make_mesh({"dp": 1, "tp": 2})
    single = make_mesh({"dp": 1}, devices=[mx.gpu(0)])
    c = PLACE_RESNET
    # Part 1: the single-device reference first, in rank 0 only, its
    # state kept on the host after every step; then the tp2 steps.
    batches = [_on_card(x, y) for x, y in
               _place_batches(c["tp_steps"], c["batch"], SEED)]
    want, single_ms = [], []
    if r == 0:
        step = _place_resnet(single)
        for x, y in batches:
            loss, t = _timed_step(step, x, y)
            single_ms.append(t)
            want.append((loss, step.state_to_host()))
        out["single_step_ms_median"] = float(np.median(single_ms[1:]))
        out["single_bytes"] = _held_bytes(step)
        out["single_max_memory"] = torch.cuda.max_memory_allocated()
        del step
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = _place_resnet(tp)
    _reset_all_launches()       # this path starts here
    losses, ms, same = [], [], []
    for k, (x, y) in enumerate(batches):
        loss, t = _timed_step(step, x, y)
        losses.append(loss)
        ms.append(t)
        state = step.state_to_host()        # gathered, on every rank
        if r == 0:
            same.append(loss == want[k][0] and _same_state(state,
                                                           want[k][1]))
    out["resnet"] = {"launches": _all_launches(),     # read just after
                     "losses": losses, "step_ms": ms,
                     "step_ms_median": float(np.median(ms[1:])),
                     "held_bytes": _held_bytes(step),
                     "max_memory": torch.cuda.max_memory_allocated(),
                     "bit_for_bit_every_step": same}
    del step, batches, want
    torch.cuda.empty_cache()
    # Part 2: the attention layer, bf16 over fp32 masters.
    a = DIST_ATTN
    ref = None
    if r == 0:
        net, x, y = _dist_attention(mx)
        step = TrainStep(net, gluon.loss.L2Loss(), "sgd", dict(a["opt"]),
                         mesh=single, dtype="bfloat16")
        losses, ms = _dist_steps(step, x, y, a["steps"])
        ref = (losses, _dist_state(step, net))
        out["attention_single_step_ms_median"] = float(np.median(ms[1:]))
        del step, net
        torch.cuda.empty_cache()
    net, x, y = _dist_attention(mx)
    step = TrainStep(net, gluon.loss.L2Loss(), "sgd", dict(a["opt"]),
                     mesh=tp, dtype="bfloat16")
    _reset_all_launches()       # this path starts here
    losses, ms = _dist_steps(step, x, y, a["steps"])
    launches = _all_launches()  # read just after it
    state = _dist_state(step, net)
    out["attention"] = {"launches": launches, "losses": losses,
                        "step_ms": ms,
                        "step_ms_median": float(np.median(ms[1:])),
                        "held_bytes": _held_bytes(step)}
    if r == 0:
        out["attention"]["loss_share_of_tolerance"] = float(np.max(
            np.abs(np.subtract(losses, ref[0])) /
            (1e-6 + 1e-5 * np.abs(ref[0]))))
        out["attention"]["state_share_of_tolerance"] = _dist_close(
            state, ref[1], 1e-5, 1e-4)
    del step, net
    torch.cuda.empty_cache()
    # Part 3's reference: {"dp": 2} on the global batches of part 3.
    dp = make_mesh({"dp": 2})
    step = _place_resnet(dp)
    rows = dp.local_slice(c["global_batch"])
    timed = [_timed_step(step, *_on_card(x, y, rows)) for x, y in
             _place_batches(c["dp_steps"], c["global_batch"], SEED + 1)]
    losses = [loss for loss, _ in timed]
    out["dp2_step_ms"] = [t for _, t in timed]
    params, opt, aux = step.state_to_host()
    if r == 0:
        np.savez(os.path.join(outdir, "dp2.npz"), losses=np.array(losses),
                 **{"p:" + n: v for n, v in params.items()},
                 **{"s:" + n: v[0] for n, v in opt.items()},
                 **{"a:" + n: v for n, v in aux.items()})
    _dist_result(out)


def _place_part_dp2tp2(outdir):
    """Part 3: four ranks on the one card over gloo, {"dp": 2, "tp": 2};
    then the sharded checkpoint, restored on one device in rank 0."""
    import os

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.parallel import dist, make_mesh

    defaults = _place_setup()
    check(dist.initialize(backend="gloo", platform="gpu"),
          "no gloo group was formed")
    r = dist.rank()
    c = PLACE_RESNET
    mesh = make_mesh({"dp": 2, "tp": 2})
    rows = mesh.local_slice(c["global_batch"])
    batches = _place_batches(c["dp_steps"] + 1, c["global_batch"], SEED + 1)
    step = _place_resnet(mesh)
    _reset_all_launches()       # this path starts here
    losses, ms = [], []
    for x, y in batches[:-1]:
        loss, t = _timed_step(step, *_on_card(x, y, rows))
        losses.append(loss)
        ms.append(t)
    out = {"rank": r, "launches": _all_launches(),    # read just after
           "losses": losses, "step_ms": ms, "held_bytes": _held_bytes(step),
           "max_memory": torch.cuda.max_memory_allocated()}
    state = step.state_to_host()
    if r == 0:
        ref = np.load(os.path.join(outdir, "dp2.npz"))
        params, opt, aux = state
        out["dp2_bit_for_bit"] = bool(
            np.array_equal(ref["losses"], np.array(losses)) and all(
                np.array_equal(ref[pre + n], v) for pre, d in (
                    ("p:", params), ("s:", {n: s[0] for n, s in opt.items()}),
                    ("a:", aux)) for n, v in d.items()))
    t0 = time.perf_counter()
    manager = CheckpointManager(os.path.join(outdir, "ckpt"))
    manager.save(c["dp_steps"], step.state_dict(sharded=True), sync=True)
    out["save_ms"] = (time.perf_counter() - t0) * 1e3
    x, y = batches[-1]
    out["next_loss"] = float(step(*_on_card(x, y, rows)))
    dist.barrier()                  # every part of the save is written
    if r == 0:
        single = _place_resnet(make_mesh({"dp": 1}, devices=[mx.gpu(0)]))
        _, restored = manager.restore()
        single.load_state_dict(restored)
        out["restored_bit_for_bit"] = _same_state(single.state_to_host(),
                                                  state)
        out["restored_next_loss"] = float(single(*_on_card(x, y)))
        del single
    # The replicas under cuDNN's default algorithms (TF32, not
    # deterministic): each rank's own state after `dp_steps` steps, with
    # the step's replica broadcast and, as a reading, without it.
    del step
    torch.cuda.empty_cache()
    _place_restore(defaults)
    for key, sync in (("replicas", True), ("replicas_unsynced", False)):
        step = _place_resnet(mesh)
        if not sync:
            step._sync_replicas = lambda loss, grads, aux: (loss, grads, aux)
        out[key + "_step_ms"] = [_timed_step(step, *_on_card(x, y, rows))[1]
                                 for x, y in batches[:-1]]
        out[key] = _replica_digests(step)
        out["split"] = sorted(n for n in step._param_vals
                              if step._split(n) is not None)
        del step
        torch.cuda.empty_cache()
    _dist_result(out)


def _two_group_symbol(mx):
    """tests/test_executor_groups.py's symbol: fc1 and its relu in group
    dev1, fc2 in dev2."""
    x = mx.sym.Variable("x")
    with mx.AttrScope(ctx_group="dev1"):
        h = mx.sym.FullyConnected(x, num_hidden=6, name="fc1")
        h = mx.sym.Activation(h, act_type="relu", name="act1")
    with mx.AttrScope(ctx_group="dev2"):
        out = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return out


def _tol_share(got, want, rtol, atol):
    """max |got - want| / (atol + rtol |want|) of two NDArrays: <= 1 is
    within the tolerance."""
    g, w = got.asnumpy(), want.asnumpy()
    return float((np.abs(g - w) / (atol + rtol * np.abs(w))).max())


def _place_two_groups(mx):
    """The two-group symbol at {dev1: gpu(0), dev2: cpu(0)} and the
    reverse against a bind on gpu(0): values, gradients, and each
    output's and gradient's device."""
    from mxnet_tpu_torch import executor

    rng = np.random.RandomState(7)
    arrays = {"x": rng.randn(4, 5), "fc1_weight": rng.randn(6, 5),
              "fc1_bias": rng.randn(6), "fc2_weight": rng.randn(3, 6),
              "fc2_bias": rng.randn(3)}
    group = {"x": "dev1", "fc1_weight": "dev1", "fc1_bias": "dev1",
             "fc2_weight": "dev2", "fc2_bias": "dev2"}

    def run(g2c, ctx):
        where = {k: g2c[group[k]] if g2c else ctx for k in arrays}
        args = {k: mx.nd.array(v.astype(np.float32), ctx=where[k])
                for k, v in arrays.items()}
        grads = {k: mx.nd.zeros(v.shape, ctx=where[k])
                 for k, v in arrays.items()}
        ex = _two_group_symbol(mx).bind(ctx, args, args_grad=grads,
                                        group2ctx=g2c)
        before = sum(executor.CROSS_DEVICE_BYTES)
        out = ex.forward(is_train=True)[0]
        ex.backward()
        crossed = sum(executor.CROSS_DEVICE_BYTES) - before
        return out, ex.grad_dict, where, crossed

    rtol, grtol, atol = PLACE_GROUPS_TOL
    want, want_g, _, _ = run(None, mx.gpu(0))
    line = {}
    for tag, g2c in (("card_then_host", {"dev1": mx.gpu(0),
                                         "dev2": mx.cpu(0)}),
                     ("host_then_card", {"dev1": mx.cpu(0),
                                         "dev2": mx.gpu(0)})):
        out, grads, where, crossed = run(g2c, mx.gpu(0))
        fwd = _tol_share(out, want, rtol, atol)
        bwd = max(_tol_share(grads[k], want_g[k], grtol, atol)
                  for k in arrays)
        devices = out._data.device == g2c["dev2"].torch_device and all(
            grads[k]._data.device == where[k].torch_device for k in arrays)
        line[tag] = {"forward_share_of_tolerance": fwd,
                     "gradient_share_of_tolerance": bwd,
                     "devices_are_the_groups": devices,
                     "output_context": str(out.context),
                     "bytes_crossed": crossed}
        check(fwd <= 1.0 and bwd <= 1.0,
              "part 4: group2ctx %s against one device: forward %.3g, "
              "gradients %.3g of the tolerance" % (tag, fwd, bwd))
        check(devices and crossed > 0,
              "part 4: group2ctx %s left an output or gradient off its "
              "group's device, or crossed no boundary" % tag)
    return line


def _place_groups(card_line):
    """Part 4 in this process: group2ctx, then the model-parallel LSTM."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples import model_parallel_lstm

    _reset_all_launches()       # this path starts here
    line = {"part": "group2ctx", "card": card_line,
            "two_groups": _place_two_groups(mx)}
    c = PLACE_LM

    def flags(vocab, steps):
        return ["--vocab", str(vocab), "--embed", str(LM["embed"]),
                "--hidden", str(LM["hidden"]), "--layers", str(LM["layers"]),
                "--batch-size", str(LM["batch"]), "--seq-len", "20",
                "--steps", str(steps)]

    for tag, run, vocab, steps in (
            ("lstm_lm_widths", model_parallel_lstm.train, LM["vocab"],
             c["width_steps"]),
            ("lstm_learns", model_parallel_lstm.main, c["learn_vocab"],
             c["steps"])):
        got = run(flags(vocab, steps))      # main raises unless it learns
        line[tag] = {
            "vocab": vocab, "steps": steps, "placement": got["placement"],
            "nll_first": got["first"], "nll_last": got["last"],
            "nll": got["history"],
            "step_ms_median": float(np.median(got["step_ms"][1:])),
            "bytes_crossed_per_step": got["cross_bytes_per_step"][-1]}
    read = _all_launches()      # read just after it
    log(json.dumps(line))
    return read


def phase_placement(card_line):
    """Phase 21: tensor-parallel TrainStep, sharded checkpoints and
    group2ctx. The ranks run in child processes of the port's launcher
    (gloo: NCCL refuses two ranks on one card); part 4 runs here.
    Returns each path's launch read."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    outdir = tempfile.mkdtemp(prefix="phase21_")
    try:
        p2 = _dist_launch("place2", 2, 0, outdir)
        p2 = sorted(p2, key=lambda p: p["rank"])
        r0 = p2[0]
        line1 = {"part": "resnet50_tp2", "card": card_line,
                 "mesh": {"dp": 1, "tp": 2}, "batch": PLACE_RESNET["batch"],
                 "dtype": "float32",
                 "step_ms_median_per_rank": [p["resnet"]["step_ms_median"]
                                             for p in p2],
                 "losses": r0["resnet"]["losses"],
                 "bit_for_bit_every_step":
                     r0["resnet"]["bit_for_bit_every_step"],
                 "held_bytes_per_rank": [p["resnet"]["held_bytes"]
                                         for p in p2],
                 "single_bytes": r0["single_bytes"],
                 "single_step_ms_median": r0["single_step_ms_median"],
                 "held_share_per_rank": [p["resnet"]["held_bytes"] /
                                         r0["single_bytes"] for p in p2],
                 "max_memory_per_rank": [p["resnet"]["max_memory"]
                                         for p in p2],
                 "single_max_memory": r0["single_max_memory"]}
        log(json.dumps(line1))
        check(r0["resnet"]["bit_for_bit_every_step"] ==
              [True] * PLACE_RESNET["tp_steps"],
              "part 1: the tp2 ResNet-50 state is not the single-device "
              "step's bit for bit: %s" % r0["resnet"]["bit_for_bit_every_step"])
        a = r0["attention"]
        line2 = {"part": "attention_tp2", "card": card_line,
                 "mesh": {"dp": 1, "tp": 2}, "dtype": "bfloat16",
                 "step_ms_median_per_rank": [p["attention"]["step_ms_median"]
                                             for p in p2],
                 "single_step_ms_median":
                     r0["attention_single_step_ms_median"],
                 "launches_per_rank": [p["attention"]["launches"]["k1_k2_k3"]
                                       for p in p2],
                 "losses": a["losses"],
                 "loss_share_of_tolerance": a["loss_share_of_tolerance"],
                 "state_share_of_tolerance": a["state_share_of_tolerance"],
                 "held_bytes_per_rank": [p["attention"]["held_bytes"]
                                         for p in p2]}
        log(json.dumps(line2))
        check(a["loss_share_of_tolerance"] <= 1.0 and
              a["state_share_of_tolerance"] <= 1.0,
              "part 2: tp2 against the single-device run: loss %.3g, state "
              "%.3g of the tolerance" % (a["loss_share_of_tolerance"],
                                         a["state_share_of_tolerance"]))
        for p in p2:
            check(tuple(p["attention"]["launches"]["k1_k2_k3"]) ==
                  (DIST_ATTN["steps"],) * 3,
                  "part 2: K1/K2/K3 launches %s per rank, not once a step "
                  "each" % (p["attention"]["launches"]["k1_k2_k3"],))
        p4 = sorted(_dist_launch("place4", 4, 0, outdir),
                    key=lambda p: p["rank"])
        q0 = p4[0]
        gap = abs(q0["restored_next_loss"] - q0["next_loss"])
        line3 = {"part": "resnet50_dp2_tp2", "card": card_line,
                 "mesh": {"dp": 2, "tp": 2},
                 "global_batch": PLACE_RESNET["global_batch"],
                 "losses": q0["losses"],
                 "step_ms_per_rank": [p["step_ms"] for p in p4],
                 "dp2_step_ms_per_rank": [p["dp2_step_ms"] for p in p2],
                 "held_bytes_per_rank": [p["held_bytes"] for p in p4],
                 "max_memory_per_rank": [p["max_memory"] for p in p4],
                 "dp2_bit_for_bit": q0["dp2_bit_for_bit"],
                 "sharded_save_ms_per_rank": [p["save_ms"] for p in p4],
                 "restored_bit_for_bit": q0["restored_bit_for_bit"],
                 "next_loss": q0["next_loss"],
                 "restored_next_loss": q0["restored_next_loss"],
                 "next_loss_share_of_tolerance":
                     gap / (1e-6 + 1e-5 * abs(q0["next_loss"]))}
        log(json.dumps(line3))
        check(q0["dp2_bit_for_bit"], "part 3: dp2 x tp2 is not the dp2 "
              "step bit for bit")
        check(q0["restored_bit_for_bit"], "part 3: the sharded save "
              "restored on one device is not the gathered state")
        check(line3["next_loss_share_of_tolerance"] <= 1.0,
              "part 3: the restored step's next loss %.7g against dp2 x "
              "tp2's %.7g" % (q0["restored_next_loss"], q0["next_loss"]))
        tp_of = [p["rank"] % 2 for p in p4]
        split = set(q0["split"])
        apart = _replicas_apart([p["replicas"] for p in p4], split, tp_of)
        unsynced = _replicas_apart([p["replicas_unsynced"] for p in p4],
                                   split, tp_of)
        log(json.dumps({"part": "resnet50_dp2_tp2_default_algorithms",
                        "card": card_line, "state_keys": len(q0["replicas"]),
                        "step_ms_per_rank": [p["replicas_step_ms"]
                                             for p in p4],
                        "step_ms_per_rank_without_the_broadcast": [
                            p["replicas_unsynced_step_ms"] for p in p4],
                        "replicas_apart": len(apart),
                        "replicas_apart_without_the_broadcast": len(unsynced),
                        "apart_without_the_broadcast_first": unsynced[:8]}))
        check(not apart, "part 3: under cuDNN's default algorithms the "
              "replicas differ across ranks: %s" % apart[:8])
        groups = _place_groups(card_line)
        log("phase 21 seconds", round(time.perf_counter() - t_phase, 3))
        return {"placement_resnet_tp2":
                    _sum_reads([p["resnet"]["launches"] for p in p2]),
                "placement_attention_tp2":
                    _sum_reads([p["attention"]["launches"] for p in p2]),
                "placement_resnet_dp2_tp2":
                    _sum_reads([p["launches"] for p in p4]),
                "placement_group2ctx": groups}
    finally:
        shutil.rmtree(outdir, ignore_errors=True)


# Phase 22: telemetry and profiling on the training paths.
TELE_COST_STEPS = 4         # steps a configuration of part 3 is timed over
TELE_COST_ORDER = ("off", "default", "device_spans",
                   "device_spans", "default", "off")
TELE_XPROF_S = 0.5          # seconds of the /debug/xprof capture (part 1)
TELE_ATTN_STEPS = 3         # profiled attention steps (part 2)
TELE_KERNELS = ("flash_fwd_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel",
                "flash_bwd_dq_wgmma_kernel")
TELE_RESNET = {"network": "resnet50", "batch": 32, "image": 224}
TELE_ATTN = {"units": 1024, "heads": 16, "batch": 8, "seq": 2048}
# The collapsed captures of part 1's xprof window and part 2's profiled
# steps, which part 5 reads with the telemetry tools.
TELE_CAPTURES = ("resnet.collapsed", "attention.collapsed")
XPROF_SERVE_CLIENTS = 4     # probe_xprof_abort(load="serve")'s clients


def _http(url, method="GET"):
    """(status, body) of one request to the health plane on localhost."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, method=method,
                                 data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def probe_xprof_abort(card_line, captures=30, park=True, load="train"):
    """Phase 22 part 1's ``/debug/xprof`` capture (TELE_XPROF_S) from
    another thread while the card works, `captures` times in one process,
    with no check: one line a capture, its status, the steps (or served
    batches) it spanned and its kernel records. ``load="train"``: this
    thread trains ResNet-50 v1 b32 bf16 through TrainStep;
    ``load="serve"``: an ``InferenceServer`` serves the same net in fp32
    (buckets 1/8/32) to ``XPROF_SERVE_CLIENTS`` client threads sending 8
    rows a request, its worker parking at ``profiler.step_boundary``
    before each batch. ``park=False`` replaces ``profiler._quiesced`` by
    a no-op, so the session starts and stops while the card's work is
    launched. A native abort ends the process; its exit code tells. Not
    run by main(): ``python3 -c "import chip_smoke as c;
    c.probe_xprof_abort(c.phase_device(), park=False, load='serve')"``."""
    import contextlib
    import os
    import shutil
    import tempfile
    import threading

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import profiler, serving, telemetry
    from mxnet_tpu_torch.examples import train_imagenet

    if not park:
        profiler._quiesced = contextlib.nullcontext
    tmp = tempfile.mkdtemp(prefix="xprof_probe_")
    plane = telemetry.HealthPlane(xprof_dir=os.path.join(tmp, "xprof"))
    server = telemetry.start_http_server(0, health=plane)
    base = "http://%s:%d" % server.server_address[:2]
    rng = np.random.RandomState(SEED)
    b, side = TELE_RESNET["batch"], TELE_RESNET["image"]
    done = threading.Event()
    served = [0]
    if load == "train":
        step = train_imagenet.build_train_step(
            TELE_RESNET["network"], 1000, "bfloat16", mx.gpu(0))
        x = torch.from_numpy(rng.rand(b, 3, side, side).astype(
            np.float32)).cuda()
        y = torch.from_numpy(rng.randint(0, 1000, b).astype(
            np.float32)).cuda()
        for _ in range(3):
            float(step(x, y))
        clients, srv = [], None
    else:
        net = _resnet50()
        srv = serving.InferenceServer(lambda v: net(v),
                                      item_shape=(3, side, side),
                                      buckets=(1, 8, 32), max_delay_ms=2)
        rows = rng.rand(8, 3, side, side).astype(np.float32)

        def client():
            while not done.is_set():
                srv.predict(rows)
                served[0] += 1

        clients = [threading.Thread(target=client, daemon=True)
                   for _ in range(XPROF_SERVE_CLIENTS)]
        for c in clients:
            c.start()
    t_start = time.perf_counter()
    try:
        for k in range(captures):
            reply = []
            t = threading.Thread(target=lambda: reply.append(_http(
                base + "/debug/xprof?seconds=%g" % TELE_XPROF_S, "POST")))
            before = served[0]
            t.start()
            i = 0
            while t.is_alive() or i < 5:
                i += 1
                if load == "train":
                    float(step(x, y))
                else:
                    time.sleep(0.01)
            t.join(timeout=120)
            kernels = None
            if reply and reply[0][0] == 200:
                path = os.path.join(json.loads(reply[0][1])["dir"],
                                    "trace.json")
                kernels = sum(1 for e in _trace_events(path)
                              if e.get("cat") == "kernel")
                shutil.rmtree(os.path.dirname(path), ignore_errors=True)
            log(json.dumps({"probe": "xprof_abort", "park": park,
                            "load": load, "capture": k,
                            "status": reply and reply[0][0],
                            "steps": i if load == "train" else None,
                            "requests": served[0] - before,
                            "kernel_records": kernels,
                            "process_s": time.perf_counter() - t_start,
                            "card": card_line}))
    finally:
        done.set()
        for c in clients:
            c.join(timeout=60)
        if srv is not None:
            srv.shutdown()
        server.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _lost_kernel_records(events):
    """How many kernel launches of a chrome trace have no kernel record:
    each launch call (the runtime's or the driver's) and the kernel it
    launched share a correlation id."""
    kernels = {e["args"]["correlation"] for e in events
               if e.get("cat") == "kernel" and "correlation" in
               e.get("args", {})}
    launches = [e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and re.match(r"cu(da)?LaunchKernel", e.get("name", ""))
                and "correlation" in e.get("args", {})]
    return sum(1 for c in launches if c not in kernels)


def _tele_resnet(card_line, tmp):
    """Part 1: ResNet-50 v1 b32 bf16 TrainStep with StepMonitor,
    DeviceMemoryMonitor, FlightRecorder, GoodputLedger and a HealthPlane
    served over HTTP. Returns the step (part 3 reuses it), its batch and
    the monitor."""
    import os
    import threading

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.examples import train_imagenet
    from mxnet_tpu_torch.telemetry import flamegraph, goodput
    from mxnet_tpu_torch.telemetry import healthplane as hp
    from mxnet_tpu_torch.telemetry import memstats, trace

    hp.reset()      # earlier phases' components are not this path's
    step = train_imagenet.build_train_step(TELE_RESNET["network"], 1000,
                                           "bfloat16", mx.gpu(0))
    monitor = telemetry.StepMonitor(warmup_steps=3)
    recorder = telemetry.FlightRecorder(os.path.join(tmp, "diag"), rank=0,
                                        rate_limit_s=0.0)
    recorder.attach(monitor)
    mem = telemetry.DeviceMemoryMonitor(interval_s=0.0)
    # The ledger commits into an existing directory (part 5 reads it).
    os.makedirs(os.path.join(tmp, "goodput"))
    ledger = telemetry.GoodputLedger(os.path.join(tmp, "goodput"), rank=0,
                                     interval_s=0.0)
    goodput.install(ledger)
    plane = telemetry.HealthPlane(
        watchdog=telemetry.HangWatchdog(min_deadline_s=30.0),
        recorder=recorder, goodput=ledger,
        xprof_dir=os.path.join(tmp, "xprof"))
    server = telemetry.start_http_server(0, health=plane)
    base = "http://%s:%d" % server.server_address[:2]
    try:
        rng = np.random.RandomState(SEED)
        b, side = TELE_RESNET["batch"], TELE_RESNET["image"]
        x = torch.from_numpy(rng.rand(b, 3, side, side).astype(np.float32))
        y = torch.from_numpy(rng.randint(0, 1000, b).astype(np.float32))
        during = []
        loss_fn = step.loss_fn

        def probe(pred, label):
            # Inside the first step: its readiness slot exists, not ready.
            if not during:
                during.append(_http(base + "/readyz"))
            return loss_fn(pred, label)

        step.loss_fn = probe
        first = _http(base + "/readyz")
        with monitor.step(0):
            loss = step(x, y)
        float(loss)
        step.loss_fn = loss_fn
        after = _http(base + "/readyz")
        check(first[0] == 200 and during[0][0] == 503
              and json.loads(during[0][1])["components"] ==
              {"train_step": False},
              "/readyz before the first step ended: %s, %s"
              % (first, during))
        check(after[0] == 200 and json.loads(after[1])["components"] ==
              {"train_step": True}, "/readyz after the first step: %s"
              % (after,))
        x, y = x.to(step._device), y.to(step._device)
        torch.cuda.synchronize()
        want = (torch.cuda.memory_allocated(0),
                torch.cuda.max_memory_allocated(0))
        sample = memstats.sample_device_memory()["cuda:0"]
        check((sample["bytes"], sample["peak_bytes"]) == want,
              "memstats %s against torch.cuda's in use and peak %s"
              % (sample, want))
        # /debug/xprof from another thread while this one trains; the
        # window's spans are folded into a collapsed capture.
        reply = []
        t = threading.Thread(target=lambda: reply.append(_http(
            base + "/debug/xprof?seconds=%g" % TELE_XPROF_S, "POST")))
        trace.clear()
        t.start()
        i, t0 = 0, time.perf_counter()
        while t.is_alive() or i < 5:
            i += 1
            s0 = time.perf_counter()
            with monitor.step(i):
                loss = step(x, y)
                float(loss)
            ledger.observe_step(step.num_update, time.perf_counter() - s0)
            mem.tick()
            ledger.tick()
        t.join(timeout=120)
        xprof_s = time.perf_counter() - t0
        flamegraph.dump_collapsed(os.path.join(tmp, TELE_CAPTURES[0]))
        steps_ms = xprof_s * 1e3 / i
        check(reply and reply[0][0] == 200, "/debug/xprof: %s" % reply)
        events = _trace_events(os.path.join(
            json.loads(reply[0][1])["dir"], "trace.json"))
        kernels = [e for e in events if e.get("cat") == "kernel"]
        tid = threading.get_native_id()
        launches_here = sum(1 for e in events
                            if e.get("cat") == "cuda_runtime"
                            and e.get("tid") == tid
                            and "Launch" in e.get("name", ""))
        check(kernels, "the /debug/xprof trace holds no kernel events")
        health = _http(base + "/healthz")
        metrics = _http(base + "/metrics")
        bundle = _http(base + "/debug/bundle", "POST")
        memory = _http(base + "/debug/memory")
        good = _http(base + "/debug/goodput")
        check(health[0] == 200 and metrics[0] == 200
              and b"mx_train_steps_total" in metrics[1]
              and b"mx_device_live_bytes" in metrics[1],
              "/healthz %d, /metrics %d" % (health[0], metrics[0]))
        check(bundle[0] == 200 and memory[0] == 200 and good[0] == 200,
              "/debug/bundle %d, /debug/memory %d, /debug/goodput %d"
              % (bundle[0], memory[0], good[0]))
        with open(json.loads(bundle[1])["bundle"]) as f:
            env = json.load(f)["env"]
        snap = ledger.snapshot()
        line = {"part": "telemetry_resnet50_bf16", "card": card_line,
                "readyz": [first[0], during[0][0], after[0]],
                "memstats": sample, "torch_cuda": list(want),
                "xprof_steps": i, "xprof_step_ms": steps_ms,
                "xprof_seconds": xprof_s,
                "xprof_kernel_events": len(kernels),
                "xprof_launches_on_training_thread": launches_here,
                "monitor": monitor.snapshot(),
                "memory_limit_gb": sample["limit_bytes"] / 1e9,
                "goodput_ratio": snap["goodput_ratio"],
                "goodput_closure_ok": snap["closure_ok"],
                "bundle_env": {k: env.get(k) for k in
                               ("torch", "cuda", "device")},
                "compile": memstats.compile_stats().get("train_step")}
        log(json.dumps(line))
        check(env.get("device") == torch.cuda.get_device_name(0),
              "the bundle names %r" % env.get("device"))
        return step, x, y, monitor
    finally:
        server.close()
        goodput.uninstall(ledger)


def _tele_attention(card_line, tmp, monitor):
    """Part 2: the attention layer through gluon.Trainer (adam) with a
    halting NumericGuard on its fused applier, TELE_ATTN_STEPS steps
    under the device trace, then a NaN gradient."""
    import os

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon, nd, profiler, telemetry
    from mxnet_tpu_torch.examples.attention_layer import SelfAttention
    from mxnet_tpu_torch.telemetry import flamegraph, trace

    units, b, seq = TELE_ATTN["units"], TELE_ATTN["batch"], TELE_ATTN["seq"]
    mx.random.seed(SEED)
    net = SelfAttention(units, heads=TELE_ATTN["heads"])
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    net.cast("bfloat16")
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-3, "multi_precision": True})
    guard = telemetry.NumericGuard(monitor=monitor, halt=True)
    guard.install(trainer._applier)
    rng = np.random.default_rng(SEED)
    x = nd.array(rng.standard_normal((b, seq, units), dtype=np.float32),
                 ctx=mx.gpu(0), dtype="bfloat16")
    y = nd.array(rng.standard_normal((b, seq, units), dtype=np.float32),
                 ctx=mx.gpu(0))
    loss_fn = gluon.loss.L2Loss()

    def one(step):
        guard.observe_batch(step=step)
        loss = _record_and_backward(net, x, y, True, loss_fn)
        trainer.step(b)
        return float(loss.asnumpy().mean())

    losses = [one(1)]                       # warm: plans and states
    step = 2
    path = os.path.join(tmp, "attention_trace.json")
    profiler.set_config(filename=path)
    before = _launches()
    torch.cuda.synchronize()
    trace.clear()
    profiler.set_state("run")
    for _ in range(TELE_ATTN_STEPS):
        losses.append(one(step))
        step += 1
    torch.cuda.synchronize()
    flamegraph.dump_collapsed(os.path.join(tmp, TELE_CAPTURES[1]))
    counted = tuple(a - b for a, b in zip(_launches(), before))
    check(profiler.dump() == path, "profiler.dump wrote elsewhere")
    events = _trace_events(path)
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    in_trace = tuple(sum(1 for n in names if k in n) for k in TELE_KERNELS)
    lost = _lost_kernel_records(events)
    nonfinite = telemetry.REGISTRY.get("mx_nonfinite_total")
    n0 = nonfinite.labels(site="grad").value
    nan_step = step
    guard.observe_batch(step=nan_step)
    _record_and_backward(net, x, y, True, loss_fn)
    w = net.collect_params()[[n for n in net.collect_params()
                              if n.endswith("weight")][0]]
    w.grad()._data.view(-1)[0] = float("nan")
    raised = None
    try:
        trainer.step(b)
    except telemetry.NonFiniteError as exc:
        raised = str(exc)
    moved = nonfinite.labels(site="grad").value - n0
    line = {"part": "telemetry_attention_trainer", "card": card_line,
            "losses": losses, "profiled_steps": TELE_ATTN_STEPS,
            "k1_k2_k3_in_trace": in_trace, "k1_k2_k3_counted": counted,
            "kernel_events": len(names),
            "launches_without_a_kernel_record": lost,
            "nonfinite_raised": raised,
            "mx_nonfinite_total_moved": moved,
            "guard_checks": dict(guard._counts),
            "anomalies": monitor.snapshot()["anomalies"]}
    log(json.dumps(line))
    check(in_trace == counted == (TELE_ATTN_STEPS,) * 3,
          "K1/K2/K3 in the device trace %s, counted %s, want %d each"
          % (in_trace, counted, TELE_ATTN_STEPS))
    check(lost == 0, "%d kernel launches in the device trace have no "
          "kernel record" % lost)
    check(raised is not None and "at step %d" % nan_step in raised,
          "the guard did not halt at step %d: %r" % (nan_step, raised))
    check(moved == 1, "mx_nonfinite_total moved by %s" % moved)
    check(all(np.isfinite(losses)), "non-finite loss %s" % losses)


def _tele_cost(card_line, step, x, y):
    """Part 3: what telemetry costs the bf16 ResNet-50 TrainStep. Step
    ms over TELE_COST_STEPS steps (after 3 warm ones, closed by a
    synchronize) off, at the default and with attribution's device spans
    on, in turns (TELE_COST_ORDER); the step's device ms from one
    torch.profiler window of CUDA activity (telemetry changes host work
    only), and each turn's idle share as 1 - device ms / step ms."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.telemetry import attribution

    def configure(name):
        telemetry.set_enabled(name != "off")
        attribution.set_device_spans(name == "device_spans")

    rows = {}
    try:
        configure("default")
        for _ in range(3):
            step(x, y)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                step(x, y)
            torch.cuda.synchronize()
        device_ms = sum(e.self_device_time_total
                        for e in prof.key_averages()
                        if str(e.device_type).endswith("CUDA")) / 1e3 / 5
        for name in TELE_COST_ORDER:
            configure(name)
            for _ in range(3):
                step(x, y)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TELE_COST_STEPS):
                step(x, y)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / TELE_COST_STEPS
            rows.setdefault(name, []).append([ms, 1.0 - device_ms / ms])
    finally:
        configure("default")
    line = {"part": "telemetry_cost", "card": card_line,
            "steps": TELE_COST_STEPS, "order": TELE_COST_ORDER,
            "device_ms": device_ms, "step_ms_idle_share": rows,
            "step_ms_median": {k: float(np.median([r[0] for r in v]))
                               for k, v in rows.items()}}
    log(json.dumps(line))
    check(device_ms > 0, "part 3: the profiler saw no device time")


def _tool_text(tool, argv):
    """What one of the port's tools prints through its ``main(argv)``
    in this process (standard output captured); it must return 0."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = tool.main(list(argv))
    check(code == 0, "%s %s returned %s" % (tool.__name__, argv, code))
    return buf.getvalue()


def _tele_tools(card_line, tmp):
    """Part 5: the port's telemetry tools over the files parts 1 and 2
    committed (the flight recorder's bundles, the goodput ledger, the
    two collapsed captures), each through its ``main(argv)`` in this
    process. Returns the part's readings."""
    import os

    from mxnet_tpu_torch.telemetry import flamegraph, goodput
    from mxnet_tpu_torch.telemetry.recorder import DIAG_RE
    from mxnet_tpu_torch.tools import (diagnose, flame_diff, goodput_report,
                                       profile_tool)

    card = torch.cuda.get_device_name(0)
    diag = os.path.join(tmp, "diag")
    names = sorted(n for n in os.listdir(diag) if DIAG_RE.match(n))
    plain = _tool_text(diagnose, [diag])
    merged = _tool_text(diagnose, ["--merge", diag])
    env_lines = [row for row in plain.splitlines()
                 if row.startswith("env:")]
    memory = []
    for name in names:
        with open(os.path.join(diag, name)) as f:
            bundle = json.load(f)
        rec = (bundle.get("device_memory") or {}).get("cuda:0")
        if rec:
            memory.append("device cuda:0: %s live" % diagnose._fmt_bytes(
                rec.get("bytes") or 0))
    ledger = os.path.join(tmp, "goodput", goodput.ledger_name(0))
    snap = goodput.load_ledger(ledger)
    summary = _tool_text(goodput_report, ["summary", ledger])
    compare = _tool_text(goodput_report, ["compare", ledger, ledger])
    deltas = [float(row.split()[-2]) for row in compare.splitlines()
              if row.endswith(" pp")]
    deltas.append(float(compare.split("(")[1].split()[0]))
    resnet, attention = (os.path.join(tmp, n) for n in TELE_CAPTURES)
    tops = {n: _tool_text(profile_tool, ["top", os.path.join(tmp, n)])
            for n in TELE_CAPTURES}
    # The share column of each top's rows, in percent.
    shares = {n: [float(row.rsplit(None, 1)[-1].rstrip("%"))
                  for row in t.splitlines()[2:] if row.endswith("%")]
              for n, t in tops.items()}
    out = os.path.join(tmp, "merged.collapsed")
    _tool_text(profile_tool, ["merge", "-o", out, resnet, attention])

    def total(path):
        with open(path) as f:
            return sum(flamegraph._parse_collapsed(f.read()).values())

    diff = _tool_text(profile_tool, ["diff", resnet, attention])
    fdiff = _tool_text(flame_diff, [resnet, attention])
    line = {"part": "telemetry_tools", "card": card_line,
            "bundles": names, "diagnose_env": env_lines,
            "diagnose_memory": memory,
            "goodput": {"wall_s": snap["wall_s"],
                        "goodput_ratio": snap["goodput_ratio"]},
            "compare_deltas_pp": deltas,
            "top_rows": {n: t.splitlines()[2:5] for n, t in tops.items()},
            "top_share_sum": {n: sum(v) for n, v in shares.items()},
            "capture_self_us": [total(resnet), total(attention)],
            "merged_self_us": total(out),
            "diff_rows": fdiff.splitlines()[2:6]}
    log(json.dumps(line))
    check(len(names) >= 2, "phase 22 committed %d bundles" % len(names))
    check("%d bundle(s) summarized" % len(names) in plain
          and "%d bundle(s) summarized" % len(names) in merged
          and "INCIDENT kind=" in merged,
          "diagnose summarized other than the %d bundles" % len(names))
    check(len(env_lines) == len(names) and all(
        ", device %s," % card in row for row in env_lines),
        "diagnose's env lines do not name %r: %s" % (card, env_lines))
    check(memory and all(m in plain for m in memory),
          "diagnose's cuda:0 lines miss the bundles' bytes %s" % memory)
    check("wall-clock       %12.3f s" % snap["wall_s"] in summary
          and "goodput ratio    %11.1f %%" % (snap["goodput_ratio"] * 100.0)
          in summary, "goodput_report summary against load_ledger %s:\n%s"
          % (line["goodput"], summary))
    check(len(deltas) > 2 and all(d == 0.0 for d in deltas),
          "goodput_report compare of a ledger with itself: %s" % deltas)
    for name, v in shares.items():
        check(v and sum(v) <= 100.0 + 0.05 * len(v),
              "profile_tool top %s: shares %s" % (name, v))
    check(line["merged_self_us"] == sum(line["capture_self_us"]),
          "profile_tool merge: %s self us from %s"
          % (line["merged_self_us"], line["capture_self_us"]))
    check(diff == fdiff and "Self-time share diff" in diff,
          "profile_tool diff and flame_diff differ:\n%s\n%s"
          % (diff, fdiff))
    return line


def phase_telemetry(card_line):
    """Phase 22: telemetry and profiling (module docstring). Returns
    each path's launch read."""
    import shutil
    import tempfile

    from mxnet_tpu_torch.examples import train_telemetry

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase22_")
    reads = {}
    try:
        seconds = {}
        t = time.perf_counter()
        _reset_all_launches()       # this path starts here
        step, x, y, monitor = _tele_resnet(card_line, tmp)
        reads["telemetry_resnet"] = _all_launches()     # just after it
        check(reads["telemetry_resnet"]["k1_k2_k3"] == (0, 0, 0),
              "ResNet-50 launched flash attention kernels")
        seconds["resnet"], t = time.perf_counter() - t, time.perf_counter()
        _reset_all_launches()
        _tele_attention(card_line, tmp, monitor)
        reads["telemetry_attention"] = _all_launches()
        seconds["attention"], t = time.perf_counter() - t, time.perf_counter()
        _reset_all_launches()
        _tele_cost(card_line, step, x, y)
        reads["telemetry_cost"] = _all_launches()
        seconds["cost"], t = time.perf_counter() - t, time.perf_counter()
        del step, x, y
        _reset_all_launches()
        code = train_telemetry.main(["--num-batches", "40", "--out-dir",
                                     tmp + "/example"])
        reads["telemetry_example"] = _all_launches()
        check(code == 0, "examples.train_telemetry ended with %d" % code)
        seconds["example"], t = time.perf_counter() - t, time.perf_counter()
        _tele_tools(card_line, tmp)
        seconds["tools"] = time.perf_counter() - t
        log(json.dumps({"phase": "telemetry", "part_seconds": seconds}))
        log("phase 22 seconds", round(time.perf_counter() - t_phase, 3))
        return reads
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 23: the multi-model gateway, hot reload, SLO shedding, continuous
# batching of the LSTM LM, and the mesh-sharded ResNet-50 over two ranks.
GW_BUCKETS = {"resnet": (1, 8, 32), "attention": (1, 2, 4, 8)}
GW_ITEM = {"resnet": (3, 224, 224), "attention": (3, 16, 2048, 64)}
GW_LOAD_S = 3.0             # part 1's load, seconds
GW_THREADS = 8              # part 1's client threads
GW_POOL = 6                 # distinct requests per model (rows 1-8)
GW_SWAP_S = (1.5, 1.5)      # part 2: load before and after the swap
GW_FLOOD_S = 4.0            # part 3's flood, seconds
GW_SLO = (0.99, 0.0005)     # part 3: the SLO the attention model cannot meet
# Phase 5's bounds for a served forward: fp32 within 1e-3 of the largest
# output, bf16 within 0.1 of it; attention within kernel_tolerance.
GW_TOL = {"fp32": 1e-3, "bf16": 0.1}
# Part 4: the LSTM LM of phase 16 (LM: vocabulary 10 000, embedding and
# hidden 200, two layers) decoding greedily, 32 slots in pages of 4; 128
# sequences whose lengths follow bench.py's geometric mix (mean 10, seed
# 7, clipped to 1-128); prompts of 1-16 tokens from the synthetic corpus.
GW_DECODE = {"slots": 32, "page_slots": 4, "sequences": 128,
             "mean_len": 10, "len_seed": 7, "max_len": 128, "max_prompt": 16,
             "generate": 6}
# Part 5: 6 lockstep requests at b8 per rank.
GW_MESH = {"requests": 6, "batch": 8}


def _gw_violation(got, want, tol):
    """Largest |got - want| as a share of tol * max|want| (<= 1 passes)."""
    want = want.float()
    return float((got.float() - want).abs().max()) / (
        tol * float(want.abs().max()))


def _gw_resnet_fn(net):
    """fn(*weights, x): the net under `weights` (gluon's override), so a
    backend holds, quantizes or replaces the weights itself."""
    from mxnet_tpu_torch.gluon.parameter import override

    pobjs = list(net.collect_params().values())

    def fn(*args):
        *weights, x = args
        with override(dict(zip(pobjs, weights))):
            return net(x)

    return fn, pobjs


def _gw_attention(x):
    from mxnet_tpu_torch import nd

    xb = x.astype("bfloat16")
    return nd.contrib.flash_attention(xb[:, 0], xb[:, 1], xb[:, 2],
                                      causal=True)


def _gw_pool(kind, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, 9, GW_POOL)
    rows[:2] = (1, 8)
    item = GW_ITEM[kind]
    return [rng.standard_normal((int(r),) + item, dtype=np.float32)
            if kind == "attention" else
            rng.random((int(r),) + item, dtype=np.float32) for r in rows]


def _gw_direct(fn, params, pool):
    """`fn` on each request of the pool, on the card (a direct forward of
    the same rows, no gateway)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd

    out = []
    with torch.no_grad(), autograd.pause():
        for x in pool:
            y = fn(*(params + [nd.array(x, ctx=mx.gpu(0))]))
            out.append(y.data_.clone())
    torch.cuda.synchronize()
    return out


def _gw_clients(gw, jobs, seconds, threads):
    """`threads` clients, each cycling through its jobs (model, class,
    pool index, check) until `seconds` pass; check(result, index) raises
    on a wrong response. Returns (responses per model, errors)."""
    import threading

    stop = time.perf_counter() + seconds
    served, errors = {}, []
    lock = threading.Lock()

    def client(k):
        i = k
        while time.perf_counter() < stop:
            model, cls, pool, check_fn = jobs[i % len(jobs)]
            idx = (i // len(jobs)) % len(pool)
            i += threads
            try:
                res = gw.predict(model, pool[idx], deadline_class=cls)
                check_fn(res, idx)
            except Exception as exc:   # a drop or a wrong answer
                with lock:
                    errors.append("%s: %r" % (model, exc))
                time.sleep(0.001)   # a refused client backs off a little
                continue
            with lock:
                served[model] = served.get(model, 0) + 1

    ts = [threading.Thread(target=client, args=(k,)) for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return served, errors


def _gw_models(gw):
    """Per model: p50/p99 ms, batches, rows, occupancy, generation."""
    out = {}
    for name, st in gw.stats().items():
        b = st["buckets"]
        nb = sum(v["batches"] for v in b.values())
        rows = sum(v["rows"] for v in b.values())
        out[name] = {"p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"],
                     "batches": nb, "rows": rows,
                     "occupancy": rows / max(1, sum(v["batches"] * k
                                                    for k, v in b.items())),
                     "per_bucket_batches": {k: v["batches"]
                                            for k, v in b.items()},
                     "generation": st["generation"], "shed": st["shed"]}
    return out


def _lm_decode_fns():
    """(step, prefill) of phase 16's LM as a greedy decoder over nd ops:
    embedding, the two LSTM cells sliced from the RNN op's fused parameter
    vector, FullyConnected to the vocabulary, argmax. State (h, c), each
    (slots, 2, 200). The prefill runs the padded prompt step by step and
    keeps no update past the prompt's length."""
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ops.rnn_ops import rnn_param_layout

    V, E, H, L = LM["vocab"], LM["embed"], LM["hidden"], LM["layers"]
    layout = {n: (s, o) for n, s, o in rnn_param_layout(L, H, E)}

    def w(flat, name):
        shape, off = layout[name]
        return nd.slice_axis(flat, axis=0, begin=off,
                             end=off + int(np.prod(shape))).reshape(shape)

    def core(emb, flat, fcw, fcb, h, c, tok):
        x = nd.Embedding(tok, emb, input_dim=V, output_dim=E)
        hs, cs = [], []
        for i in range(L):
            hl = nd.slice_axis(h, axis=1, begin=i, end=i + 1).reshape((-1, H))
            cl = nd.slice_axis(c, axis=1, begin=i, end=i + 1).reshape((-1, H))
            g = nd.FullyConnected(x, w(flat, "l%d_i2h_weight" % i),
                                  w(flat, "l%d_i2h_bias" % i),
                                  num_hidden=4 * H) + \
                nd.FullyConnected(hl, w(flat, "l%d_h2h_weight" % i),
                                  w(flat, "l%d_h2h_bias" % i),
                                  num_hidden=4 * H)
            gi, gf, gg, go = nd.split(g, num_outputs=4, axis=1)
            cl = nd.sigmoid(gf) * cl + nd.sigmoid(gi) * nd.tanh(gg)
            x = nd.sigmoid(go) * nd.tanh(cl)
            hs.append(x)
            cs.append(cl)
        logits = nd.FullyConnected(x, fcw, fcb, num_hidden=V)
        return nd.stack(*hs, axis=1), nd.stack(*cs, axis=1), logits

    def step(emb, flat, fcw, fcb, state, tokens, pos):
        h, c, logits = core(emb, flat, fcw, fcb, *state, tokens)
        return (h, c), nd.argmax(logits, axis=1)

    def prefill(emb, flat, fcw, fcb, prompt, length):
        h = nd.zeros((1, L, H), ctx=prompt.context)
        c = nd.zeros((1, L, H), ctx=prompt.context)
        keep = nd.zeros((1, V), ctx=prompt.context)
        lf = length.astype("float32")
        for t in range(int(prompt.shape[1])):
            tok = nd.slice_axis(prompt, axis=1, begin=t,
                                end=t + 1).reshape((1,))
            h2, c2, logits = core(emb, flat, fcw, fcb, h, c, tok)
            m = (lf > t).reshape((1, 1))
            m3 = m.reshape((1, 1, 1))
            h = nd.broadcast_mul(m3, h2) + nd.broadcast_mul(1 - m3, h)
            c = nd.broadcast_mul(m3, c2) + nd.broadcast_mul(1 - m3, c)
            keep = nd.broadcast_mul(m, logits) + nd.broadcast_mul(1 - m, keep)
        return (h, c), nd.argmax(keep, axis=1)

    return step, prefill


def _lm_decode_params(seed=SEED):
    """Random LM weights from `seed` (numpy): embedding, the fused LSTM
    vector, the output layer's weight and bias."""
    from mxnet_tpu_torch.ops.rnn_ops import rnn_param_layout

    V, E, H, L = LM["vocab"], LM["embed"], LM["hidden"], LM["layers"]
    rng = np.random.default_rng(seed)
    n = sum(int(np.prod(s)) for _, s, _ in rnn_param_layout(L, H, E))
    return [rng.uniform(-0.1, 0.1, (V, E)).astype(np.float32),
            rng.uniform(-0.2, 0.2, n).astype(np.float32),
            rng.uniform(-0.1, 0.1, (V, H)).astype(np.float32),
            np.zeros(V, np.float32)]


def _gw_decode_spec(name="lm"):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serving

    c = GW_DECODE
    step, prefill = _lm_decode_fns()
    return serving.ModelSpec(
        name, params=[mx.nd.array(p, ctx=mx.gpu(0))
                      for p in _lm_decode_params()],
        max_batch=c["slots"], ctx=mx.gpu(0),
        decode=serving.DecodeConfig(
            step, state_shape=[(LM["layers"], LM["hidden"])] * 2,
            init=prefill, page_slots=c["page_slots"],
            max_tokens=c["max_len"], max_prompt_len=c["max_prompt"]))


def _gw_alone(backend, prompt, n):
    """The tokens `backend` gives `prompt` alone in slot 0."""
    slots = GW_DECODE["slots"]
    tokens = np.zeros(slots, np.int32)
    pos = np.zeros(slots, np.int32)
    active = np.zeros(slots, bool)
    active[0] = True
    out = [backend.admit(0, prompt)]
    tokens[0] = out[0]
    while len(out) < n:
        tokens[0] = backend.step(backend.page_count(1), tokens, pos,
                                 active)[0]
        out.append(int(tokens[0]))
    return out


def _gw_decode(card_line, gw):
    """Part 4: continuous batching of the LSTM LM against the static pass
    on one backend; every sequence's tokens against the same prompt
    alone; then the model through the gateway beside part 1's models."""
    from mxnet_tpu_torch.serving import DecodeLoop
    from mxnet_tpu_torch.telemetry import metrics as tm

    c = GW_DECODE
    corpus = _lm_corpus()
    lengths = np.clip(np.random.RandomState(c["len_seed"]).geometric(
        1 / c["mean_len"], size=c["sequences"]), 1, c["max_len"])
    prompts = [np.asarray(corpus[i][:1 + i % c["max_prompt"]], np.int32)
               for i in range(c["sequences"])]
    spec = _gw_decode_spec("lm_decode")
    backend = spec.build_backend()
    t0 = time.perf_counter()
    backend.warm()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm = backend.compile_count
    total = int(lengths.sum())
    # The static pass: admit a batch of 32, step until its longest ends.
    tokens = np.zeros(c["slots"], np.int32)
    pos = np.zeros(c["slots"], np.int32)
    static_steps = 0
    t0 = time.perf_counter()
    for i in range(0, c["sequences"], c["slots"]):
        batch = lengths[i:i + c["slots"]]
        n_pages = backend.page_count(len(batch))
        active = np.zeros(c["slots"], bool)
        for slot in range(len(batch)):
            tokens[slot] = backend.admit(slot, prompts[i + slot])
        for s in range(1, int(batch.max())):
            active[:len(batch)] = s < batch
            backend.step(n_pages, tokens, pos, active)
            static_steps += 1
    static_s = time.perf_counter() - t0
    # The continuous loop on the same backend.
    steps_fam = tm.REGISTRY.get("mx_decode_steps_total")
    steps0 = steps_fam.labels(model="lm_decode").value
    loop = DecodeLoop(spec, backend)
    try:
        t0 = time.perf_counter()
        seqs = [loop.submit(p, max_tokens=int(n))
                for p, n in zip(prompts, lengths)]
        results = [s.future.result(timeout=600) for s in seqs]
        cont_s = time.perf_counter() - t0
    finally:
        loop.close()
    cont_steps = int(steps_fam.labels(model="lm_decode").value - steps0)
    ttft = np.array([r.ttft_s for r in results]) * 1e3
    alone = [_gw_alone(backend, p, int(n)) for p, n in zip(prompts, lengths)]
    differ = [i for i, (r, a) in enumerate(zip(results, alone))
              if r.tokens != a]
    after = backend.compile_count
    # Through the gateway, beside part 1's models.
    gw.register(_gw_decode_spec("lm"))
    gen = [gw.generate("lm", prompts[i], max_tokens=int(lengths[i]))
           for i in range(c["generate"])]
    gen_differ = [i for i, r in enumerate(gen) if r.tokens != alone[i]]
    line = {"part": "continuous_batching_lstm_lm", "card": card_line,
            "config": {k: LM[k] for k in ("vocab", "embed", "hidden",
                                          "layers")},
            "slots": c["slots"], "page_slots": c["page_slots"],
            "sequences": c["sequences"], "tokens": total,
            "lengths_mean": float(lengths.mean()),
            "lengths_max": int(lengths.max()),
            "warm_s": warm_s, "compile_count_after_warm": warm,
            "compile_count_after_run": after,
            "continuous": {"steps": cont_steps, "seconds": cont_s,
                           "tokens_s": total / cont_s,
                           "p50_ttft_ms": float(np.percentile(ttft, 50)),
                           "p99_ttft_ms": float(np.percentile(ttft, 99))},
            "static": {"steps": static_steps, "seconds": static_s,
                       "tokens_s": total / static_s},
            "sequences_unlike_alone": differ,
            "gateway_generate": {"sequences": len(gen),
                                 "unlike_alone": gen_differ,
                                 "generations": [r.generation for r in gen]}}
    log(json.dumps(line))
    check(after == warm, "part 4: compile_count moved after warm(): %d -> %d"
          % (warm, after))
    check(not differ, "part 4: %d sequences decode unlike the same prompt "
          "alone (first %s)" % (len(differ), differ[:8]))
    check(not gen_differ, "part 4: gw.generate unlike the prompt alone: %s"
          % gen_differ)
    check(cont_steps < static_steps, "part 4: the continuous loop took %d "
          "steps, the static pass %d" % (cont_steps, static_steps))
    check(all(len(r.tokens) == int(n) for r, n in zip(results, lengths)),
          "part 4: a sequence ended short of its max_tokens")
    return line


def phase_gateway(card_line):
    """Phase 23: one ModelGateway over five models (ResNet-50 v1 fp32,
    int8, bf16 and from its checkpoint through the fused BN+ReLU
    partition; causal bf16 flash attention), hot swap under fire, SLO
    shedding, continuous batching of the LSTM LM, the mesh-sharded
    ResNet-50 over two ranks and the port's serve_mnist example. Returns
    each path's launch read."""
    import os
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import checkpoint, nd, serving
    from mxnet_tpu_torch.examples import fused_bn_relu as fb
    from mxnet_tpu_torch.examples import serve_mnist
    from mxnet_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    g = mx.gpu(0)
    seconds, reads = {}, {}
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "mxnet_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="gateway-", dir=build)
    gw = None
    try:
        # -- part 1: five models behind one gateway ---------------------------
        t = time.perf_counter()
        net = _resnet50()
        _randomize_bn(net, SEED + 6)
        fn, pobjs = _gw_resnet_fn(net)
        w1 = [p.data() for p in pobjs]
        prefix = os.path.join(tmp, "resnet50_v1")
        net.export(prefix)
        pools = {"resnet": _gw_pool("resnet", SEED + 30),
                 "attention": _gw_pool("attention", SEED + 31)}
        int8_ref = serving.QuantizedFnModel(fn, w1, "int8", ctx=g)
        deq = [nd._contrib_dequantize(int8_ref._params[i],
                                      int8_ref._params[i + 1],
                                      int8_ref._params[i + 2])
               if kind == "q" else int8_ref._params[i]
               for kind, i in int8_ref.entries]
        bf16 = [p.astype("bfloat16") for p in w1]

        def bf16_fn(*args):
            *ws, x = args
            return fn(*(ws + [x.astype("bfloat16")])).astype("float32")

        want = {"resnet50": _gw_direct(fn, w1, pools["resnet"]),
                "resnet50_int8": _gw_direct(fn, deq, pools["resnet"]),
                "resnet50_bf16": _gw_direct(bf16_fn, bf16, pools["resnet"])}
        want["resnet50_ckpt"] = want["resnet50"]
        att_want = []
        for x in pools["attention"]:
            xb = torch.from_numpy(x).cuda().to(torch.bfloat16)
            ref, _ = fa.flash_attention_reference(
                xb[:, 0].contiguous(), xb[:, 1].contiguous(),
                xb[:, 2].contiguous(), causal=True)
            att_want.append(ref)
        int8_l2 = float(np.sqrt(sum(float(((a - b) ** 2).sum()) for a, b in
                                    zip(want["resnet50_int8"],
                                        want["resnet50"]))
                                / sum(float((b ** 2).sum())
                                      for b in want["resnet50"])))
        classes = (("interactive", None), ("batch", None))
        _reset_all_launches()           # this path starts here
        gw = serving.ModelGateway(ctx=g, max_queue=256, max_delay_ms=5.0,
                                  eval_interval_s=0.25)
        gw.register(serving.ModelSpec(
            "resnet50", fn=fn, params=w1, item_shape=GW_ITEM["resnet"],
            buckets=GW_BUCKETS["resnet"], deadline_classes=classes))
        gw.register(serving.ModelSpec(
            "resnet50_int8", fn=fn, params=w1, item_shape=GW_ITEM["resnet"],
            buckets=GW_BUCKETS["resnet"], quantize="int8"))
        gw.register(serving.ModelSpec(
            "resnet50_bf16", fn=fn, params=w1, item_shape=GW_ITEM["resnet"],
            buckets=GW_BUCKETS["resnet"], quantize="bf16"))
        os.environ["MXNET_SUBGRAPH_BACKEND"] = fb.BACKEND
        try:
            gw.register(serving.ModelSpec(
                "resnet50_ckpt", checkpoint=prefix, epoch=0,
                item_shape=GW_ITEM["resnet"], buckets=GW_BUCKETS["resnet"]))
        finally:
            os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
        gw.register(serving.ModelSpec(
            "attention", fn=_gw_attention, item_shape=GW_ITEM["attention"],
            buckets=GW_BUCKETS["attention"], deadline_classes=classes,
            slo=GW_SLO))
        warm_s = time.perf_counter() - t
        names = ["resnet50", "resnet50_int8", "resnet50_bf16",
                 "resnet50_ckpt", "attention"]
        for name in names:
            st = gw._state(name)
            check(st.backend.compile_count == len(st.spec.policy.buckets),
                  "part 1: %s ran %d signatures at warmup for %d buckets"
                  % (name, st.backend.compile_count,
                     len(st.spec.policy.buckets)))
        frags = {b[0]: sum(1 for n in ex._symbol._topo()
                           if n._op == "_subgraph") for b, ex in
                 gw._state("resnet50_ckpt").backend._executors.items()}
        check(all(f == 33 for f in frags.values()),
              "part 1: fused BN+ReLU fragments per bucket %s" % frags)
        tol = {"resnet50": GW_TOL["fp32"], "resnet50_int8": GW_TOL["fp32"],
               "resnet50_ckpt": GW_TOL["fp32"],
               "resnet50_bf16": GW_TOL["bf16"]}
        worst = {n: 0.0 for n in names}

        def resnet_check(name):
            def check_fn(res, idx):
                v = _gw_violation(res.output.data_, want[name][idx],
                                  tol[name])
                worst[name] = max(worst[name], v)
                check(v <= 1.0 and res.model == name,
                      "%s response off its direct forward (%.3g)" % (name, v))
            return check_fn

        def attention_check(res, idx):
            ref = att_want[idx]
            v = max_violation(res.output.data_, ref,
                              *fa.kernel_tolerance(ref.dtype, ref))
            worst["attention"] = max(worst["attention"], float(v))
            check(v <= 0, "attention response off its plain version")

        jobs = [(n, None, pools["resnet"], resnet_check(n))
                for n in names[:4]]
        jobs.append(("attention", "interactive", pools["attention"],
                     attention_check))
        served, errors = _gw_clients(gw, jobs, GW_LOAD_S, GW_THREADS)
        part1 = _all_launches()         # read just after it
        models = _gw_models(gw)
        held = {n: gw._state(n).backend.held_bytes for n in names}
        line1 = {"part": "gateway_five_models", "card": card_line,
                 "warm_s": warm_s, "load_s": GW_LOAD_S,
                 "threads": GW_THREADS, "served": served,
                 "errors": errors[:5], "models": models,
                 "held_bytes": held,
                 "int8_held_share_of_fp32": held["resnet50_int8"]
                 / held["resnet50"],
                 "int8_rel_l2_vs_fp32": int8_l2,
                 "worst_share_of_tolerance": worst,
                 "fused_bn_relu_fragments_per_bucket": frags,
                 "launches": part1}
        log(json.dumps(line1))
        check(not errors, "part 1: %d requests failed: %s"
              % (len(errors), errors[:3]))
        check(all(served.get(n, 0) > 0 for n in names),
              "part 1: a model served nothing: %s" % served)
        ckpt_fwd = 3 + models["resnet50_ckpt"]["batches"]
        att_fwd = 4 + models["attention"]["batches"]
        check(part1["bn_relu"] == 33 * ckpt_fwd == part1["rtc"],
              "part 1: K4a launched %d times (rtc %d) for %d checkpoint "
              "forwards" % (part1["bn_relu"], part1["rtc"], ckpt_fwd))
        check(part1["k1_k2_k3"] == (att_fwd, 0, 0),
              "part 1: K1-K3 launched %s for %d attention forwards"
              % (part1["k1_k2_k3"], att_fwd))
        check(part1["scale_add"] == part1["relu"] == 0
              and part1["d1_d2"] == (0, 0, 0),
              "part 1 launched another kernel: %s" % part1)
        zero = {k: (0,) * len(v) if isinstance(v, tuple) else 0
                for k, v in part1.items()}
        reads["gateway_attention"] = dict(zero, k1_k2_k3=part1["k1_k2_k3"])
        reads["gateway_checkpoint_partitioned"] = dict(
            zero, rtc=part1["rtc"], bn_relu=part1["bn_relu"])
        seconds["five_models"] = time.perf_counter() - t

        # -- part 2: hot swap under fire -----------------------------------
        t = time.perf_counter()
        _reset_all_launches()
        net2 = _resnet50(seed=SEED + 1)
        _randomize_bn(net2, SEED + 7)
        names2 = [p.name for p in net2.collect_params().values()]
        w2 = [p.data() for p in net2.collect_params().values()]
        want2 = _gw_direct(fn, w2, pools["resnet"])
        gap = min(_gw_violation(a, b, GW_TOL["fp32"])
                  for a, b in zip(want2, want["resnet50"]))
        check(gap > 100, "part 2: the two generations' forwards differ by "
              "only %.3g of the tolerance" % gap)
        mgr = checkpoint.CheckpointManager(os.path.join(tmp, "swap"),
                                           keep_last=2)
        mgr.save(1, {n: w.asnumpy() for n, w in zip(names2, w2)}, sync=True)
        del net2
        gens = {1: want["resnet50"], 2: want2}
        seen = {1: 0, 2: 0}

        def swap_check(res, idx):
            own = _gw_violation(res.output.data_, gens[res.generation][idx],
                                GW_TOL["fp32"])
            other = _gw_violation(res.output.data_,
                                  gens[3 - res.generation][idx],
                                  GW_TOL["fp32"])
            check(own <= 1.0 < other, "generation %d response: %.3g of the "
                  "tolerance from its own forward, %.3g from the other's"
                  % (res.generation, own, other))
            seen[res.generation] += 1

        import threading

        box = {}

        def swapper():
            time.sleep(GW_SWAP_S[0])
            t_swap = time.perf_counter()
            box["gen"] = serving.hot_swap(
                gw, "resnet50", manager=mgr,
                extract=lambda state: [nd.array(state[n], ctx=g)
                                       for n in names2])
            box["ms"] = (time.perf_counter() - t_swap) * 1e3

        th = threading.Thread(target=swapper)
        th.start()
        served2, errors2 = _gw_clients(
            gw, [("resnet50", "interactive", pools["resnet"], swap_check)],
            sum(GW_SWAP_S) + 1.0, 4)
        th.join()
        mgr.close()
        reads["gateway_hot_swap"] = _all_launches()
        line2 = {"part": "hot_swap_under_fire", "card": card_line,
                 "served": served2, "dropped": len(errors2),
                 "errors": errors2[:5], "by_generation": seen,
                 "swap_ms": box.get("ms"), "new_generation": box.get("gen"),
                 "generations_gap_share_of_tolerance": gap}
        log(json.dumps(line2))
        check(not errors2, "part 2: %d requests dropped or wrong: %s"
              % (len(errors2), errors2[:3]))
        check(box.get("gen") == 2 and seen[1] > 0 and seen[2] > 0,
              "part 2: generations seen %s, swap gave %s"
              % (seen, box.get("gen")))
        seconds["hot_swap"] = time.perf_counter() - t

        # -- part 3: SLO-coupled shedding ------------------------------------
        t = time.perf_counter()
        _reset_all_launches()
        before = _gw_models(gw)
        lat = []

        def unchecked(res, idx):
            pass

        flood = [("attention", "batch", pools["attention"][:1], unchecked)] \
            * 5 + [("attention", "interactive", pools["attention"][:1],
                    attention_check)] * 2
        stop = time.perf_counter() + GW_FLOOD_S
        r_err = []

        def moderate():
            i = 0
            while time.perf_counter() < stop:
                x = pools["resnet"][i % GW_POOL]
                t0 = time.perf_counter()
                try:
                    res = gw.predict("resnet50", x)
                    swap_check(res, i % GW_POOL)
                    lat.append(time.perf_counter() - t0)
                except Exception as exc:
                    r_err.append(repr(exc))
                i += 1
                time.sleep(0.02)

        mt = [threading.Thread(target=moderate) for _ in range(2)]
        for th in mt:
            th.start()
        served3, errors3 = _gw_clients(gw, flood, GW_FLOOD_S, len(flood))
        for th in mt:
            th.join()
        reads["gateway_shedding"] = _all_launches()
        after = _gw_models(gw)
        shed = after["attention"]["shed"]
        att_batches = after["attention"]["batches"] - \
            before["attention"]["batches"]
        low = [e for e in errors3 if "ServiceUnavailable" in e]
        other_err = [e for e in errors3 if "ServiceUnavailable" not in e]
        line3 = {"part": "slo_shedding", "card": card_line,
                 "slo": GW_SLO, "flood_s": GW_FLOOD_S,
                 "served": served3, "shed": shed,
                 "lowest_class_refused": len(low),
                 "other_errors": other_err[:5],
                 "resnet50_requests": len(lat), "resnet50_errors": r_err[:5],
                 "resnet50_p50_ms_while_burning":
                     float(np.percentile(lat, 50)) * 1e3 if lat else None,
                 "resnet50_p99_ms_while_burning":
                     float(np.percentile(lat, 99)) * 1e3 if lat else None,
                 "attention_batches": att_batches,
                 "launches": reads["gateway_shedding"]}
        log(json.dumps(line3))
        check(shed.get("slo_burn:batch", 0) > 0 and low,
              "part 3: the lowest class shed nothing: %s" % shed)
        check(not other_err and not r_err and not any(
            k.startswith(("queue_full", "deadline", "slo_burn:interactive"))
            for k in shed),
              "part 3: the highest class or resnet50 dropped requests: %s %s "
              "%s" % (other_err[:3], r_err[:3], shed))
        check(reads["gateway_shedding"]["k1_k2_k3"] == (att_batches, 0, 0),
              "part 3: K1 launched %s for %d attention batches"
              % (reads["gateway_shedding"]["k1_k2_k3"], att_batches))
        seconds["slo_shedding"] = time.perf_counter() - t

        # -- part 4: continuous batching of the LSTM LM ----------------------
        t = time.perf_counter()
        _reset_all_launches()
        _gw_decode(card_line, gw)
        reads["gateway_decode"] = _all_launches()
        seconds["decode"] = time.perf_counter() - t
        log(json.dumps({"part": "gateway_registry", "card": card_line,
                        "describe": gw.registry.describe()}))
        gw.shutdown()
        gw = None

        # -- part 5: the mesh-sharded ResNet-50 over two ranks ---------------
        t = time.perf_counter()
        ranks = sorted(_dist_launch("gateway_mesh", 2, 0, tmp),
                       key=lambda p: p["rank"])
        line5 = {"part": "mesh_sharded_resnet50_tp2", "card": card_line,
                 "mesh": {"tp": 2}, "requests": GW_MESH["requests"],
                 "batch": GW_MESH["batch"],
                 "bit_for_bit_per_rank": [p["bit_for_bit"] for p in ranks],
                 "held_bytes_per_rank": [p["held_bytes"] for p in ranks],
                 "full_bytes": ranks[0]["full_bytes"],
                 "held_share_per_rank": [p["held_bytes"] / p["full_bytes"]
                                         for p in ranks],
                 "ms_per_request_per_rank": [p["ms"] for p in ranks],
                 "compile_count_per_rank": [p["compile_count"]
                                            for p in ranks]}
        log(json.dumps(line5))
        check(all(p["bit_for_bit"] == [True] * GW_MESH["requests"]
                  for p in ranks),
              "part 5: the mesh outputs are not the unsharded model's bit "
              "for bit: %s" % line5["bit_for_bit_per_rank"])
        check(all(0.45 <= s <= 0.55 for s in line5["held_share_per_rank"]),
              "part 5: a rank holds %s of the weights' bytes"
              % line5["held_share_per_rank"])
        check(ranks[0]["digest"] == ranks[1]["digest"],
              "part 5: the ranks' outputs differ")
        reads["gateway_mesh"] = _sum_reads([p["launches"] for p in ranks])
        seconds["mesh"] = time.perf_counter() - t

        # -- part 6: the port's serve_mnist example --------------------------
        t = time.perf_counter()
        _reset_all_launches()
        ex = serve_mnist.main(["--requests", "256"])
        reads["gateway_example"] = _all_launches()
        log(json.dumps({"part": "serve_mnist_example", "card": card_line,
                        **ex}))
        check(ex["requests"] == 256 and ex["accuracy"] > 0.9,
              "part 6: serve_mnist served %d requests at accuracy %.3f"
              % (ex["requests"], ex["accuracy"]))
        seconds["example"] = time.perf_counter() - t
        log(json.dumps({"phase": "gateway", "part_seconds": seconds}))
        log("phase 23 seconds", round(time.perf_counter() - t_phase, 3))
        return reads
    finally:
        if gw is not None:
            gw.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


def _gateway_part_mesh(outdir):
    """Part 5: one rank of the mesh-sharded ResNet-50 ({"tp": 2} over two
    gloo ranks on the one card): a gateway with the model, 6 lockstep
    requests at b8, each output against the unsharded model's on the
    same batch."""
    import hashlib

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.parallel import dist
    from mxnet_tpu_torch.serving.engine import _FnModel

    _place_setup()
    check(dist.initialize(backend="gloo", platform="gpu"),
          "no gloo group was formed")
    g = mx.gpu(0)
    net = _resnet50()
    _randomize_bn(net, SEED + 6)
    fn, pobjs = _gw_resnet_fn(net)
    w = [p.data() for p in pobjs]
    plain = _FnModel(fn, w, ctx=g)
    c = GW_MESH
    gw = serving.ModelGateway(ctx=g, max_delay_ms=1.0)
    out = {"rank": dist.rank()}
    try:
        _reset_all_launches()           # this path starts here
        gw.register(serving.ModelSpec(
            "resnet50_tp2", fn=fn, params=w, item_shape=GW_ITEM["resnet"],
            buckets=(c["batch"],), mesh_axes={"tp": 2}))
        backend = gw._state("resnet50_tp2").backend
        rng = np.random.default_rng(SEED + 40)
        same, ms, h = [], [], hashlib.sha256()
        for _ in range(c["requests"]):
            x = rng.random((c["batch"],) + GW_ITEM["resnet"],
                           dtype=np.float32)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = gw.predict("resnet50_tp2", x).output.data_
            ms.append((time.perf_counter() - t0) * 1e3)
            u = plain(mx.nd.array(x, ctx=g)).data_
            same.append(bool(torch.equal(y, u)))
            h.update(y.cpu().numpy().tobytes())
        out["launches"] = _all_launches()   # read just after it
        out.update({"bit_for_bit": same, "ms": ms,
                    "held_bytes": backend.held_bytes,
                    "full_bytes": plain.held_bytes,
                    "compile_count": backend.compile_count,
                    "digest": h.hexdigest()})
    finally:
        gw.shutdown()
    _dist_result(out)


# Each rank of a phase-19, -20, -21 or -23 part runs this file with
# --dist-part <key>.
# -- slice 20: the compile cache ---------------------------------------------

CC_ITEM = (3, 224, 224)     # phase 10's ResNet-50 v1, served at b32
CC_ATTN = (8, 16, 2048, 64)  # phase 4's bucket 8: K1, bf16, causal
CC_BOXES = (32, 400)        # D1 at the SSD decode's b32 x nms_topk 400
# Every launch count of a child's path (_all_launches, as JSON): K1 once,
# K4a and K4's rtc launch under it 33 times, D1 once, no other kernel.
CC_LAUNCHES = {"k1_k2_k3": [1, 0, 0], "rtc": 33, "bn_relu": 33,
               "scale_add": 0, "relu": 0, "d1_d2": [1, 0, 0]}


def _process_age():
    """Seconds since this process started (/proc/self/stat's start time
    against /proc/uptime)."""
    import os

    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def _cc_counters():
    """The compile cache's metric families, summed per series, and the
    port's compile counts."""
    from mxnet_tpu_torch import _native, _nvrtc
    from mxnet_tpu_torch.telemetry import metrics as tm

    out = {}
    for name in ("hits", "misses", "errors", "pushed", "pulled",
                 "prefetched"):
        fam = tm.REGISTRY.get("mx_compile_cache_%s_total" % name)
        series = {} if fam is None else {
            "/".join(k) if k else "": c.value for k, c in fam.collect()}
        out[name] = {"total": sum(series.values()), "series": series}
    out["native"] = dict(_native.STATS)
    out["nvrtc"] = dict(_nvrtc.STATS)
    return out


def _digest(t):
    import hashlib

    raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()


def _cc_export(outdir):
    """Phase 10's ResNet-50 v1 (BatchNorm randomized), exported once for
    the children to serve."""
    import os

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision

    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=mx.gpu(0))
    net.hybridize()
    probe = np.random.default_rng(SEED + 5).random((1,) + CC_ITEM,
                                                   dtype=np.float32)
    with torch.no_grad(), autograd.pause():
        net(nd.array(probe, ctx=mx.gpu(0)))
    _randomize_bn(net, SEED + 6)
    prefix = os.path.join(outdir, "resnet50_v1")
    net.export(prefix)
    return prefix


def _cc_work(outdir, tag, t0):
    """One child's main path: the four nvcc libraries, the checkpoint
    served through the fused BN+ReLU partition at b32 (K4a and K4's
    launch, its NVRTC program), K1 at phase 4's bucket 8 and D1 at 32 x
    400 boxes, each against its plain version. Returns what it read."""
    import os

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _native, nd, serving
    from mxnet_tpu_torch.examples import fused_bn_relu as fb
    from mxnet_tpu_torch.ops import detection_ops as det
    from mxnet_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(SEED + 24)
    batch = rng.random((32,) + CC_ITEM, dtype=np.float32)
    qkv = [torch.from_numpy(rng.standard_normal(CC_ATTN, dtype=np.float32))
           .cuda().to(torch.bfloat16) for _ in range(3)]
    b, n = CC_BOXES
    lo = rng.random((b, n, 2), dtype=np.float32) * 250
    boxes = torch.from_numpy(np.concatenate(
        [lo, lo + 8 + rng.random((b, n, 2), dtype=np.float32) * 60],
        axis=2)).cuda()
    # D1 takes class ids in the boxes' dtype.
    cls_ids = torch.from_numpy(rng.integers(0, 20, (b, n))
                               .astype(np.float32)).cuda()
    valid = torch.ones((b, n), dtype=torch.bool).cuda()
    prefix = os.path.join(outdir, "resnet50_v1")
    _reset_all_launches()       # the main path starts here
    path_start_s = time.time() - t0
    t_build = time.perf_counter()
    _native.build()
    build_s = time.perf_counter() - t_build
    # The server binds its graph (and partitions it) at its first
    # forward: the backend stays named until then.
    os.environ["MXNET_SUBGRAPH_BACKEND"] = fb.BACKEND
    t_serve = time.perf_counter()
    try:
        srv = serving.InferenceServer.from_checkpoint(
            prefix, 0, item_shape=CC_ITEM, buckets=(32,), warmup=False,
            ctx=mx.gpu(0))
        try:
            logits = srv.predict(batch).data_
            torch.cuda.synchronize()
            first_output_s = time.time() - t0
        finally:
            srv.shutdown()
    finally:
        os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
    serve_s = time.perf_counter() - t_serve
    attn = nd.contrib.flash_attention(
        *[nd.NDArray(t, ctx=mx.gpu(0)) for t in qkv], causal=True).data_
    keep = det.nms_sorted(boxes, valid, cls_ids, 0.45)
    torch.cuda.synchronize()
    launches = _all_launches()  # read just after the path
    # The plain versions: the attention and NMS references; and, in the
    # cold child, the same checkpoint served unpartitioned (the others'
    # logits are held bit for bit to the cold child's).
    ref, _ = fa.flash_attention_reference(*qkv, causal=True)
    want = det.nms_sorted_reference(boxes, valid, cls_ids, 0.45,
                                    det.IOU_CORNER, n)
    k1_err = float((attn.float() - ref.float()).abs().max())
    k4a_err = scale = None
    if tag == "cold":
        plain_srv = serving.InferenceServer.from_checkpoint(
            prefix, 0, item_shape=CC_ITEM, buckets=(32,), warmup=False,
            ctx=mx.gpu(0))
        try:
            plain_logits = plain_srv.predict(batch).data_
        finally:
            plain_srv.shutdown()
        scale = float(plain_logits.abs().max())
        k4a_err = float((logits - plain_logits).abs().max())
    return {
        "tag": tag, "build_s": build_s,
        "seconds_to_first_output": first_output_s,
        # Where they went: the process's start to its main path
        # (interpreter, imports, CUDA, the kvstore), the build, the
        # checkpoint's load, bind and first forward.
        "path_start_s": path_start_s, "serve_s": serve_s,
        "launches": launches,
        "digests": {"k4a_served_logits": _digest(logits),
                    "k1": _digest(attn),
                    "d1": [_digest(t) for t in keep]},
        "k4a_max_abs_err_vs_plain": k4a_err,
        "k4a_limit": None if scale is None else 1e-5 * scale,
        "k1_max_abs_err_vs_plain": k1_err,
        "k1_share_of_tolerance": max_violation(
            attn, ref, *fa.kernel_tolerance(ref.dtype, ref)),
        "d1_bit_for_bit": all(torch.equal(g, w) for g, w in zip(keep, want)),
        "counters": _cc_counters()}


def _cc_store_summary(store):
    return {"entries": len(store.keys()), "bytes": store.total_bytes()}


def _cc_part_ranks(outdir):
    """Phase 24, the two dist_sync ranks: rank 0 builds with an empty
    store and publishes; rank 1 waits for it at a barrier, attaches with
    prefetch and must compile nothing."""
    import os

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import _native
    from mxnet_tpu_torch import compile as cc

    t0 = time.time() - _process_age()
    kv = mx.kv.create("dist_sync")
    rank = kv.rank
    tag = "cold" if rank == 0 else "peer"
    _native.BUILD = os.path.join(outdir, "build_" + tag)
    store = cc.configure(os.path.join(outdir, "store_rank%d" % rank))
    wait = 0.0
    if rank == 0:
        cc.attach_kvstore(kv)
        result = _cc_work(outdir, tag, t0)
        # Every push is processed before rank 1 may probe: the barrier
        # drains this rank's acks first.
        kv.barrier()
    else:
        t_wait = time.time()
        kv.barrier()
        wait = time.time() - t_wait
        cc.attach_kvstore(kv)       # prefetch: one cc_probe(None) round
        result = _cc_work(outdir, tag, t0 + wait)
    result.update(rank=rank, barrier_wait_s=wait,
                  store=_cc_store_summary(store))
    kv.barrier()
    kv.close()
    _dist_result(result)


def _cc_part_warm(outdir):
    """Phase 24, a warm start: rank 0's store, a fresh BUILD, no
    kvstore."""
    import os

    from mxnet_tpu_torch import _native
    from mxnet_tpu_torch import compile as cc

    t0 = time.time() - _process_age()
    _native.BUILD = os.path.join(outdir, "build_warm")
    store = cc.configure(os.path.join(outdir, "store_rank0"))
    result = _cc_work(outdir, "warm", t0)
    result.update(store=_cc_store_summary(store))
    _dist_result(result)


def phase_compile_cache(card_line):
    """Phase 24 (see the module docstring). Returns each child's launch
    counts (every kernel's) by path."""
    import os
    import shutil
    import tempfile

    from mxnet_tpu_torch import _native

    t_phase = time.perf_counter()
    libraries = len(_native.SOURCES)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "mxnet_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    outdir = tempfile.mkdtemp(prefix="cc-", dir=build)
    try:
        t0 = time.perf_counter()
        _cc_export(outdir)
        export_s = time.perf_counter() - t0
        ranks = _dist_launch("cc_ranks", 2, 1, outdir)
        cold = next(r for r in ranks if r["rank"] == 0)
        peer = next(r for r in ranks if r["rank"] == 1)
        (warm,) = _dist_launch("cc_warm", 1, 0, outdir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    runs = {"cold": cold, "peer": peer, "warm": warm}
    entries = cold["store"]["entries"]
    c = {k: r["counters"] for k, r in runs.items()}
    line = {
        "phase": "compile_cache", "card": card_line,
        "seconds_to_first_output": {k: r["seconds_to_first_output"]
                                    for k, r in runs.items()},
        "path_start_s": {k: r["path_start_s"] for k, r in runs.items()},
        "build_s": {k: r["build_s"] for k, r in runs.items()},
        "serve_s": {k: r["serve_s"] for k, r in runs.items()},
        "peer_barrier_wait_s": peer["barrier_wait_s"], "export_s": export_s,
        "saved": {"nvcc_build_s": c["cold"]["native"]["build_seconds"],
                  "nvrtc_compile_s": c["cold"]["nvrtc"]["compile_seconds"]},
        "entries": entries, "entry_bytes": cold["store"]["bytes"],
        "launches": {k: r["launches"] for k, r in runs.items()},
        "counters": c,
        "k4a_max_abs_err_vs_plain": cold["k4a_max_abs_err_vs_plain"],
        "k4a_limit": cold["k4a_limit"],
        "k1_share_of_tolerance": {k: r["k1_share_of_tolerance"]
                                  for k, r in runs.items()},
        "seconds": time.perf_counter() - t_phase}
    log(json.dumps(line))
    check(c["cold"]["native"]["nvcc_runs"] == libraries and
          c["cold"]["nvrtc"]["compiles"] >= 1,
          "compile cache: the cold rank did not compile: %s" % c["cold"])
    # Each library's entry has its toolkit record beside it.
    check(c["cold"]["misses"]["total"] == entries - libraries ==
          libraries + c["cold"]["nvrtc"]["compiles"],
          "compile cache: rank 0 holds %d entries for %s misses"
          % (entries, c["cold"]["misses"]))
    check(c["cold"]["pushed"]["total"] == entries,
          "compile cache: rank 0 published %s of %d entries"
          % (c["cold"]["pushed"], entries))
    for k in ("peer", "warm"):
        check(c[k]["native"]["nvcc_runs"] == 0
              and c[k]["nvrtc"]["compiles"] == 0,
              "compile cache: the %s start compiled: nvcc %d, NVRTC %d"
              % (k, c[k]["native"]["nvcc_runs"], c[k]["nvrtc"]["compiles"]))
        check(c[k]["hits"]["total"] == c["cold"]["misses"]["total"]
              and c[k]["misses"]["total"] == 0,
              "compile cache: the %s start hit %s, rank 0 missed %s"
              % (k, c[k]["hits"], c["cold"]["misses"]))
        for part in ("k4a_served_logits", "k1", "d1"):
            check(runs[k]["digests"][part] == cold["digests"][part],
                  "compile cache: %s's %s output differs from rank 0's"
                  % (k, part))
    check(c["peer"]["pulled"]["total"] + c["peer"]["prefetched"]["total"]
          == entries, "compile cache: rank 1 pulled %s and prefetched %s of "
          "%d entries" % (c["peer"]["pulled"], c["peer"]["prefetched"],
                          entries))
    check(cold["k4a_max_abs_err_vs_plain"] <= cold["k4a_limit"],
          "compile cache: the partitioned forward is %g from the plain one "
          "(limit %g)" % (cold["k4a_max_abs_err_vs_plain"],
                          cold["k4a_limit"]))
    for k, r in runs.items():
        check(r["counters"]["errors"]["total"] == 0,
              "compile cache: %s counted errors %s" % (
                  k, r["counters"]["errors"]))
        check(r["launches"] == CC_LAUNCHES,
              "compile cache: %s launched %s, not %s" % (
                  k, r["launches"], CC_LAUNCHES))
        check(r["k1_share_of_tolerance"] <= 0,
              "compile cache: %s's K1 is outside its tolerance" % k)
        check(r["d1_bit_for_bit"],
              "compile cache: %s's D1 differs from its plain version" % k)
    return {"compile_cache_" + k: r["launches"] for k, r in runs.items()}


# -- phase 25: the sparse path -------------------------------------------------

# MovieLens-20M's counts (GroupLens ml-20m README: 138,493 users, 27,278
# movies); rank, batch and the synthetic rating count are the cell's.
SPARSE_MF = {"users": 138493, "items": 27278, "rank": 128, "batch": 4096,
             "samples": 262144, "lr": 0.08, "epochs": 2, "seed": SEED,
             "parity_steps": 3, "warmup": 3, "windows": 5, "iters": 10}
# benchmark/sparse_end2end.py's linear model: a CSR batch of 128 rows over
# 100,000 features, 32 nonzeros a row, times a (100000, 16) weight.
SPARSE_DOT = {"batch": 128, "features": 100000, "nnz": 32, "dim": 16,
              "file_rows": 4096}
# The card's fp32 steps against the host's float64 ones, relative L2 over
# the rows the steps touched: each step's row update carries the error of
# the prediction's 128-term dot product (gamma_128 = 128 u) and about ten
# roundings of Adam's row arithmetic, and three steps add up; u = 2^-23.
SPARSE_MF_REL_L2 = SPARSE_MF["parity_steps"] * (SPARSE_MF["rank"] + 10) \
    * 2.0 ** -23


def _mf_args(**over):
    """The example's flags at the cell's size."""
    from mxnet_tpu_torch.examples import train_matrix_factorization as mf

    c = dict(SPARSE_MF, **over)
    return mf.parse_args([
        "--num-users", str(c["users"]), "--num-items", str(c["items"]),
        "--rank", str(c["rank"]), "--samples", str(c["samples"]),
        "--batch-size", str(c["batch"]), "--epochs", str(c["epochs"]),
        "--lr", str(c["lr"]), "--optimizer", "adam",
        "--seed", str(c["seed"])])


def _mf_data(args):
    from mxnet_tpu_torch.examples import train_matrix_factorization as mf

    rng = np.random.RandomState(args.seed)
    return mf.synthetic_ratings(rng, args.num_users, args.num_items,
                                args.rank, args.samples)


def _mf_net(mx, args, ctx, sparse_grad=True, weights=None, dtype=None):
    """MFNet on `ctx` (Normal(0.1) from the seed, or `weights`, a
    {relative name: float32 array}), cast to `dtype` after its weights
    are set (the cast of float32 values is exact)."""
    from mxnet_tpu_torch.examples import train_matrix_factorization as mf
    from mxnet_tpu_torch.gluon.utils import params_from_numpy

    mx.random.seed(args.seed)
    net = mf.MFNet(args.num_users, args.num_items, args.rank,
                   sparse_grad=sparse_grad)
    net.initialize(mx.init.Normal(0.1), ctx=ctx)
    if weights is not None:
        params_from_numpy(net, weights)
    if dtype is not None:
        net.cast(dtype)
    return net


def _mf_state(net):
    """{relative name: numpy} of the net's weights."""
    return _relative({n: p.data().asnumpy() for n, p in
                      net.collect_params().items()}, net.prefix)


def _mf_batches(mx, data, args, ctx, count, dtype="float32"):
    """The first `count` batches of the training split on `ctx`."""
    users, items, ratings = data
    out = []
    for s in range(count):
        sel = slice(s * args.batch_size, (s + 1) * args.batch_size)
        out.append(tuple(mx.nd.array(a[sel], ctx=ctx, dtype=dtype)
                         for a in (users, items, ratings)))
    return out


def _mf_step(mx, net, trainer, batch):
    from mxnet_tpu_torch import autograd, gluon

    u, i, r = batch
    with autograd.record():
        loss = gluon.loss.L2Loss()(net(u, i), r).sum()
    loss.backward()
    trainer.step(u.shape[0])
    return loss


def _mf_moments(net, trainer):
    """{relative name: (mean, var)} of the trainer's Adam states."""
    from mxnet_tpu_torch.gluon.utils import relative_names

    index = {id(p): k for k, p in enumerate(trainer._params)}
    params = net.collect_params()
    rel = relative_names(list(params.keys()), net.prefix)
    return {rel[n]: tuple(s.asnumpy() for s in
                          trainer._updater.states[index[id(p)]])
            for n, p in params.items()}


def _sparse_lazy_contract(mx, net, args, data):
    """Check 1: one lazy Adam step moves exactly the batch's rows of each
    embedding, and their moments; every other row is its start, bit for
    bit."""
    from mxnet_tpu_torch import gluon

    ctx = mx.gpu(0)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": args.lr})
    batch = _mf_batches(mx, data, args, ctx, 1)[0]
    before = _mf_state(net)
    _mf_step(mx, net, trainer, batch)
    after, moments = _mf_state(net), _mf_moments(net, trainer)
    users, items = (np.unique(data[k][:args.batch_size].astype(np.int64))
                    for k in (0, 1))
    out = {}
    for name, w0 in before.items():
        rows = users if name.startswith("embedding0") or \
            name.startswith("embedding2") else items
        changed = np.nonzero((after[name] != w0).any(axis=1))[0]
        moved = [np.nonzero((m != 0).any(axis=1))[0]
                 for m in moments[name]]
        rest = np.setdiff1d(np.arange(w0.shape[0]), rows)
        out[name] = {
            "rows": int(rows.size), "changed": int(changed.size),
            "changed_are_batch": bool(np.array_equal(changed, rows)),
            "moments_are_batch": all(np.array_equal(m, rows)
                                     for m in moved),
            "rest_bit_for_bit": bool(np.array_equal(after[name][rest],
                                                    w0[rest]))}
    return out


def _sparse_card_vs_host(mx, net, args, data):
    """Check 2: `parity_steps` lazy Adam steps on the card (fp32) and on
    the host (float64) from the card's weights, the same batches; the
    relative L2 of the touched rows of each weight."""
    from mxnet_tpu_torch import gluon

    w0 = _mf_state(net)
    steps = SPARSE_MF["parity_steps"]
    runs = {}
    for where, ctx, dtype in (("card", mx.gpu(0), None),
                              ("host", mx.cpu(), "float64")):
        m = net if where == "card" else _mf_net(mx, args, ctx, weights=w0,
                                                dtype=dtype)
        tr = gluon.Trainer(m.collect_params(), "adam",
                           {"learning_rate": args.lr})
        t0 = time.perf_counter()
        for b in _mf_batches(mx, data, args, ctx, steps,
                             dtype=dtype or "float32"):
            _mf_step(mx, m, tr, b)
        runs[where] = (_mf_state(m), time.perf_counter() - t0)
    (card, _), (host, host_s) = runs["card"], runs["host"]
    n = steps * args.batch_size
    touched = {"users": np.unique(data[0][:n].astype(np.int64)),
               "items": np.unique(data[1][:n].astype(np.int64))}
    out = {"host_s": host_s, "limit": SPARSE_MF_REL_L2, "rel_l2": {},
           "untouched_moved": {}}
    for name, want in host.items():
        rows = touched["users" if name.startswith(("embedding0",
                                                   "embedding2"))
                       else "items"]
        rest = np.setdiff1d(np.arange(want.shape[0]), rows)
        out["rel_l2"][name] = _rel_l2({"w": card[name][rows]},
                                      {"w": want[rows]})
        out["untouched_moved"][name] = int(
            (card[name][rest] != w0[name][rest]).any(axis=1).sum()
            + (want[rest] != w0[name][rest]).any(axis=1).sum())
    return out


def _mf_rate(mx, args, data, sparse_grad):
    """samples/s of the example's step at the cell's size, as
    ``examples.train_imagenet.benchmark_rate`` times it: warmup steps,
    then the median of windows of steps each closed by a host read of
    the loss. With sparse_grad, also the host ms a step spends turning
    the gradients row-sparse and in the per-parameter update."""
    from mxnet_tpu_torch import gluon

    c = SPARSE_MF
    net = _mf_net(mx, args, mx.gpu(0), sparse_grad=sparse_grad)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": args.lr})
    host = {"to_row_sparse": 0.0, "row_sparse_update": 0.0, "steps": 0}

    def timed(fn, key):
        def run(*a):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                host[key] += time.perf_counter() - t0
        return run

    trainer._row_sparse_grad = timed(trainer._row_sparse_grad,
                                     "to_row_sparse")
    trainer._apply_row_sparse = timed(trainer._apply_row_sparse,
                                      "row_sparse_update")
    batches = _mf_batches(mx, data, args, mx.gpu(0), c["iters"])
    loss = None
    for s in range(c["warmup"]):
        loss = _mf_step(mx, net, trainer, batches[s % len(batches)])
    float(loss.sum().asnumpy())
    host.update(to_row_sparse=0.0, row_sparse_update=0.0)
    rates = []
    for _ in range(c["windows"]):
        t0 = time.perf_counter()
        for b in batches:
            loss = _mf_step(mx, net, trainer, b)
        float(loss.sum().asnumpy())     # completion proof
        rates.append(args.batch_size * len(batches)
                     / (time.perf_counter() - t0))
        host["steps"] += len(batches)
    steps = host.pop("steps")
    return {"samples_s": sorted(rates)[len(rates) // 2],
            "window_samples_s": rates,
            **{k + "_host_ms_per_step": v * 1e3 / steps
               for k, v in host.items()}}


def _sparse_dot_case(mx, gen):
    """Check 5: sparse.dot on the card, plain and transposed, against the
    host in float64 (SURFACE_TOL["reduce"]), with its times."""
    from mxnet_tpu_torch.ndarray import sparse as sp

    c = SPARSE_DOT
    b, f, k, d = c["batch"], c["features"], c["nnz"], c["dim"]
    cols = np.sort(gen.choice(f, (b, k)), axis=1)   # a row may repeat one
    vals = gen.rand(b, k).astype(np.float32) + 0.5
    indptr = np.arange(0, b * k + 1, k, dtype=np.int64)
    csr = sp.csr_matrix((vals.reshape(-1), cols.reshape(-1), indptr),
                        shape=(b, f), ctx=mx.gpu(0))
    rows = np.repeat(np.arange(b), k)
    out = {}
    rtol, atol_frac = SURFACE_TOL["reduce"]
    for ta, rhs_rows in ((False, f), (True, b)):
        rhs = gen.randn(rhs_rows, d).astype(np.float32)
        x = mx.nd.array(rhs, ctx=mx.gpu(0))
        got = sp.dot(csr, x, transpose_a=ta).asnumpy()
        want = np.zeros((f if ta else b, d))
        src, dst = (rows, cols.reshape(-1)) if ta else \
            (cols.reshape(-1), rows)
        np.add.at(want, dst, vals.reshape(-1, 1).astype(np.float64)
                  * rhs[src].astype(np.float64))
        viol = max_violation(torch.from_numpy(got).double(),
                             torch.from_numpy(want), rtol,
                             atol_frac * float(np.abs(want).max()))
        out["transpose_a" if ta else "plain"] = {
            "shape": list(got.shape), "violation": viol,
            "on_card": bool(sp.dot(csr, x, transpose_a=ta)._data.is_cuda),
            "ms": time_ms(lambda: sp.dot(csr, x, transpose_a=ta))}
    return out


def _write_libsvm_file(path, gen):
    c = SPARSE_DOT
    with open(path, "w") as f:
        for _ in range(c["file_rows"]):
            cols = np.sort(gen.choice(c["features"], c["nnz"],
                                      replace=False))
            vals = gen.rand(c["nnz"]) + 0.25
            f.write("%d %s\n" % (gen.randint(2), " ".join(
                "%d:%.6f" % cv for cv in zip(cols, vals))))


def _sparse_libsvm(mx, path):
    """Check 6: LibSVMIter on the card equals the host iterator bit for
    bit, batch by batch, its CSR arrays on gpu(0)."""
    c = SPARSE_DOT
    its = [mx.io.LibSVMIter(data_libsvm=path, data_shape=(c["features"],),
                            batch_size=c["batch"], ctx=ctx)
           for ctx in (mx.gpu(0), mx.cpu())]
    t0 = time.perf_counter()
    card = list(its[0])
    card_s = time.perf_counter() - t0
    host = list(its[1])
    same = len(card) == len(host) == c["file_rows"] // c["batch"]
    on_card = True
    for g, w in zip(card, host):
        a, b = g.data[0], w.data[0]
        on_card &= all(t._data.is_cuda for t in (a, a.indptr, a.indices,
                                                 g.label[0]))
        for x, y in ((a.indptr, b.indptr), (a.indices, b.indices),
                     (a.data, b.data), (g.label[0], w.label[0])):
            same &= bool(np.array_equal(x.asnumpy(), y.asnumpy()))
    return {"batches": len(card), "bit_for_bit": bool(same),
            "on_card": bool(on_card), "card_s": card_s,
            "nnz": int(sum(g.data[0].indices.shape[0] for g in card))}, \
        card[0].data[0]


def _sparse_files_and_store(mx, net, args, data, csr, tmp):
    """Check 7: a step's row-sparse gradient and a CSR batch saved from
    the card load back to it bit for bit, in the bytes the port writes
    from the same arrays on the host; a device kvstore holding
    user.weight answers row_sparse_pull into a CUDA row-sparse out."""
    import os

    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.ndarray import sparse as sp

    u, i, r = _mf_batches(mx, data, args, mx.gpu(0), 1)[0]
    with autograd.record():
        loss = gluon.loss.L2Loss()(net(u, i), r).sum()
    loss.backward()
    grad = sp.dense_to_rsp_device(net.user.weight.grad())
    arrays = {"user_grad": grad, "batch": csr}
    card_f, host_f = (os.path.join(tmp, n) for n in ("card.params",
                                                     "host.params"))
    mx.nd.save(card_f, arrays)
    mx.nd.save(host_f, {k: v.as_in_context(mx.cpu())
                        for k, v in arrays.items()})
    back = mx.nd.load(card_f, ctx=mx.gpu(0))
    loaded = all(
        type(back[k]) is type(v) and back[k]._data.is_cuda
        and back[k].shape == v.shape
        and all(np.array_equal(x.asnumpy(), y.asnumpy())
                for x, y in zip([back[k].data] + back[k]._aux(),
                                [v.data] + v._aux()))
        for k, v in arrays.items())
    with open(card_f, "rb") as f1, open(host_f, "rb") as f2:
        same_bytes = f1.read() == f2.read()
    kv = mx.kv.create("device")
    kv.init("user", net.user.weight.data())
    rows = mx.nd.array(np.unique(u.asnumpy()), ctx=mx.gpu(0), dtype="int64")
    out = sp.zeros("row_sparse", (rows.shape[0], args.rank), ctx=mx.gpu(0))
    kv.row_sparse_pull("user", out=out, row_ids=rows)
    want = net.user.weight.data().asnumpy()[rows.asnumpy()]
    return {"grad_rows": int(grad.indices.shape[0]),
            "file_bytes": os.path.getsize(card_f),
            "loaded_bit_for_bit_on_card": bool(loaded),
            "card_file_equals_host_file": bool(same_bytes),
            "row_sparse_pull": {
                "rows": int(rows.shape[0]),
                "on_card": bool(out._data.is_cuda
                                and out.indices._data.is_cuda),
                "bit_for_bit": bool(np.array_equal(out.data.asnumpy(),
                                                   want)
                                    and np.array_equal(
                                        out.indices.asnumpy(),
                                        rows.asnumpy()))}}


def phase_sparse(card_line):
    """Phase 25 (see the module docstring). Returns its launch counts."""
    import os
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples import train_matrix_factorization as mf

    t_phase = time.perf_counter()
    args = _mf_args()
    _reset_all_launches()   # the main path starts here
    data = _mf_data(args)
    net = _mf_net(mx, args, mx.gpu(0))
    read = {"phase": "sparse", "card": card_line}

    def reading(name, value):
        read[name] = value
        log(json.dumps({"phase": "sparse", "reading": name,
                        "card": card_line, name: value}))

    reading("lazy_contract", _sparse_lazy_contract(mx, net, args, data))
    reading("card_vs_host", _sparse_card_vs_host(mx, net, args, data))
    t0 = time.perf_counter()
    vals = mf.train(args, mx.gpu(0))
    reading("training", {"val_rmse": vals,
                         "seconds": time.perf_counter() - t0})
    reading("rate_lazy", _mf_rate(mx, args, data, True))
    reading("rate_dense", _mf_rate(mx, args, data, False))
    gen = np.random.RandomState(SEED)
    reading("dot", _sparse_dot_case(mx, gen))
    tmp = tempfile.mkdtemp(prefix="sparse-", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "mxnet_tpu_torch",
        "_build"))
    try:
        path = os.path.join(tmp, "features.libsvm")
        _write_libsvm_file(path, gen)
        libsvm, csr = _sparse_libsvm(mx, path)
        reading("libsvm", libsvm)
        reading("files_and_store",
                _sparse_files_and_store(mx, net, args, data, csr, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = _all_launches()   # read just after the path
    read["launches"] = launches
    read["seconds"] = time.perf_counter() - t_phase
    log(json.dumps(read))
    for name, c in read["lazy_contract"].items():
        check(c["changed_are_batch"] and c["moments_are_batch"]
              and c["rest_bit_for_bit"],
              "sparse: the lazy step of %s: %s" % (name, c))
    cvh = read["card_vs_host"]
    for name, e in cvh["rel_l2"].items():
        check(e <= SPARSE_MF_REL_L2, "sparse: card vs host, %s's touched "
              "rows at relative L2 %g (limit %g)" % (name, e,
                                                     SPARSE_MF_REL_L2))
    check(not any(cvh["untouched_moved"].values()),
          "sparse: untouched rows moved: %s" % cvh["untouched_moved"])
    check(vals[-1] < vals[0], "sparse: validation RMSE did not fall: %s"
          % vals)
    for name, c in read["dot"].items():
        check(c["violation"] <= 0 and c["on_card"],
              "sparse: dot %s: %s" % (name, c))
    check(libsvm["bit_for_bit"] and libsvm["on_card"],
          "sparse: LibSVMIter: %s" % libsvm)
    fs = read["files_and_store"]
    check(fs["loaded_bit_for_bit_on_card"] and
          fs["card_file_equals_host_file"] and
          fs["row_sparse_pull"]["on_card"] and
          fs["row_sparse_pull"]["bit_for_bit"], "sparse: files and the "
          "store: %s" % fs)
    check(not any(any(v) if isinstance(v, (tuple, list)) else v
                  for v in launches.values()),
          "sparse: a kernel launched on the sparse path: %s" % launches)
    return {"sparse": launches}


# -- slice 22: int8 calibration, custom operators, gluon.contrib ---------------

# tests/test_quantization.py's LeNet acceptance.
QUANT_LENET = {"batch": 50, "epochs": 10, "lr": 0.01, "calib": 100,
               "min_fp32": 0.7, "max_drop": 0.01}
# ResNet-50 v1 quantized at full width, served at phase 10's buckets.
QUANT_RESNET = {"batch": 32, "item": (3, 224, 224), "naive_examples": 128,
                "entropy_examples": 32, "buckets": (1, 8, 32),
                "host_images": 2}
QUANT_NODES = 54              # 53 convolutions and the classifier
QUANT_K4A_PER_FORWARD = 33    # phase 10's fragments
# Naive ranges over the same images, card against host: the same fp32
# forward with other summation orders (cuDNN against the host's
# convolutions). An activation's error is a few u times the depth it
# went through (about 50 layers, u = 2^-24 each, grown by BatchNorm's
# scales): ~1e-5 of the layer's largest magnitude; the limit leaves 10x.
QUANT_RANGE_RTOL = 1e-4
# int8 logits, card against host and partitioned against plain: the
# contractions are exact on both sides (int32 on the card, float64 on
# the host), so they differ only where an fp32 rounding before a
# requantization (cuDNN's BatchNorm, K4a's or the host's; about half the
# BatchNorm outputs differ by an ulp) moves an activation across a
# rounding edge. One such flip changes the next accumulators by whole
# weights, which moves more activations across edges downstream: on the
# host the first flip of a partitioned against a plain int8 forward of
# this net (64 px, b8) came at the 17th quantized layer, and 139 204 of
# 6 979 584 int8 activations differed by the classifier, by up to 7
# steps. Two int8 evaluations then differ by int8 noise, not fp32
# rounding: each is an int8 approximation of the fp32 net, so the limit
# is int8's own distance from fp32 (relative L2), taken on the host from
# its int8 and fp32 forwards of the same images, so that nothing the
# card computes sets its own limit. A card fault that scales the logits
# by k reads about sqrt((k-1)^2 + flips^2) and fails once |k-1| nears
# the limit; the card's top-1 must also be the host's. K4a itself is
# held per fragment to its tolerance against its plain version on the
# same inputs (K4A_RTOL, K4A_ATOL_REL, phase 9's).
K4A_RTOL, K4A_ATOL_REL = 1e-5, 1e-6
CUSTOM_STEPS = 3
# The custom softmax head against SoftmaxOutput on the same logits: the
# probabilities and the gradient p - onehot from two float32 softmaxes
# (exp, the sum, a division), a few roundings apart: 4u relative L2
# (u = 2^-24) ~ 2.4e-7; limit 1e-6.
CUSTOM_HEAD_REL_L2 = 1e-6
# The Modules' updates from one state: the forward is the same
# computation (cuDNN deterministic) and the backward is linear in the
# head's gradient, but it passes 53 train-mode BatchNorms, whose
# gradient subtracts each channel's mean and projection of its input
# gradient: the cancellation grows a relative difference. On an H100
# the updates differed by 8.2e-6 to 9.7e-6 (PERF.md, Findings), ~40x
# the head's 4u. Limit 1e-4 (10x).
CUSTOM_UPDATE_REL_L2 = 1e-4
# Shi et al. 2015, Moving MNIST: 64x64 frames as 4x4 patches give
# (16, 16, 16) inputs; three ConvLSTM layers of 128, 64, 64 channels,
# 5x5 kernels, 10 input frames, batch 16. Parity at batch 2.
CONVLSTM = {"batch": 16, "frames": 10, "input": (16, 16, 16),
            "hidden": (128, 64, 64), "kernel": 5, "lr": 0.01, "steps": 3,
            "parity_batch": 2}
# Jozefowicz et al. 2016, LSTM-2048-512 over the One Billion Word
# vocabulary (793 471 words), NCE with 25 noise samples a position (the
# top of the upstream nce-loss scripts' 5-25), T 20, batch 32; tied
# input embedding. Parity at a 65 536-row table, batch 8, drop rate 0.
LSTMP_NCE = {"batch": 32, "T": 20, "hidden": 2048, "proj": 512,
             "vocab": 793471, "noise": 25, "drop": 0.2, "lr": 0.1,
             "steps": 3, "parity_vocab": 65536, "parity_batch": 8}
# One step's gradients, card fp32 (TF32 off) against host float64,
# relative L2 over every tensor: each K-term dot product carries about
# sqrt(K) u (K up to 3 200 for a 5x5x128 convolution, 2 048 for the
# LSTMP's; u = 2^-24), ~3.4e-6, and smooth gates (sigmoid, tanh; no
# kinks) pass it on without growth: limit 1e-5.
CONTRIB_F64_REL_L2 = 1e-5


def _lenet_data():
    """tests/test_quantization.py's synthetic 4-class images (class k
    puts a bright patch in quadrant k)."""
    rng = np.random.RandomState(42)
    n = 400
    X = (rng.rand(n, 1, 12, 12) * 0.3).astype(np.float32)
    y = rng.randint(0, 4, n).astype(np.float32)
    quads = [(slice(0, 6), slice(0, 6)), (slice(0, 6), slice(6, 12)),
             (slice(6, 12), slice(0, 6)), (slice(6, 12), slice(6, 12))]
    for i in range(n):
        r, c = quads[int(y[i])]
        X[i, 0, r, c] += 1.0
    return X, y


def _lenet_sym(mx):
    data = mx.sym.var("data")
    c1 = mx.sym.Convolution(data, kernel=(3, 3), num_filter=8, name="c1")
    a1 = mx.sym.Activation(c1, act_type="relu")
    p1 = mx.sym.Pooling(a1, kernel=(2, 2), stride=(2, 2), pool_type="max")
    f1 = mx.sym.FullyConnected(p1, num_hidden=32, name="f1")
    a2 = mx.sym.Activation(f1, act_type="relu")
    f2 = mx.sym.FullyConnected(a2, num_hidden=4, name="f2")
    return mx.sym.SoftmaxOutput(f2, name="softmax")


def _quant_lenet(mx):
    """Part 1: the LeNet trained with Module.fit on the card from a
    gluon DataLoader through contrib.io.DataLoaderIter, quantized with
    naive calibration over 100 examples, scored int8."""
    from mxnet_tpu_torch.contrib.io import DataLoaderIter
    from mxnet_tpu_torch.contrib.quantization import quantize_model
    from mxnet_tpu_torch.ops import quantization_ops as qo

    c = QUANT_LENET
    X, y = _lenet_data()
    gdata = mx.gluon.data

    def loader_iter(lo, hi, shuffle=False):
        with mx.gpu(0):
            return DataLoaderIter(gdata.DataLoader(
                gdata.ArrayDataset(X[lo:hi], y[lo:hi]),
                batch_size=c["batch"], shuffle=shuffle))

    mx.random.seed(SEED)
    np.random.seed(SEED)
    train = loader_iter(0, 300, True)
    with mx.gpu(0):
        on_card = train.next().data[0].context == mx.gpu(0)
        train.reset()
    mod = mx.mod.Module(_lenet_sym(mx), context=mx.gpu(0),
                        label_names=["softmax_label"])
    t0 = time.perf_counter()
    with mx.gpu(0):
        mod.fit(train, num_epoch=c["epochs"], optimizer="adam",
                optimizer_params={"learning_rate": c["lr"]})
    fit_s = time.perf_counter() - t0
    test = loader_iter(300, 400)
    with mx.gpu(0):
        fp32 = mod.score(test, mx.metric.Accuracy())[0][1]
    arg, aux = mod.get_params()
    t0 = time.perf_counter()
    with mx.gpu(0):
        qsym, qargs, qaux = quantize_model(
            mod.symbol, arg, aux, calib_mode="naive",
            calib_data=loader_iter(0, c["calib"]),
            num_calib_examples=c["calib"])
    calib_s = time.perf_counter() - t0
    qmod = mx.mod.Module(qsym, context=mx.gpu(0),
                         label_names=["softmax_label"])
    with mx.gpu(0):
        test.reset()
        qmod.bind(data_shapes=test.provide_data,
                  label_shapes=test.provide_label, for_training=False)
        qmod.set_params(qargs, qaux, allow_missing=False)
        test.reset()
        g0, f0 = qo.INT8_GEMMS, qmod._execs[0].num_forwards
        q = qmod.score(test, mx.metric.Accuracy())[0][1]
    forwards = qmod._execs[0].num_forwards - f0
    quantized = sorted(n for n in qargs if n.endswith("_quantized_weight"))
    return {"fp32_accuracy": fp32, "int8_accuracy": q,
            "quantized_weights": quantized,
            "int8_dtypes": sorted({str(qargs[n].dtype) for n in quantized}),
            "int8_gemms": qo.INT8_GEMMS - g0, "forwards": forwards,
            "batches_on_card": bool(on_card), "fit_s": fit_s,
            "calib_s": calib_s}


def _quant_export(mx, tmp):
    """ResNet-50 v1 (random weights from SEED, BatchNorm statistics
    randomized as phase 10's) exported; (prefix, symbol, arg, aux)."""
    import os

    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision

    mx.random.seed(SEED)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=mx.gpu(0))
    net.hybridize()
    with torch.no_grad(), autograd.pause():
        net(nd.zeros((1,) + QUANT_RESNET["item"], ctx=mx.gpu(0)))
    _randomize_bn(net, SEED + 6)
    with torch.no_grad(), autograd.pause():
        net(nd.zeros((1,) + QUANT_RESNET["item"], ctx=mx.gpu(0)))
    prefix = os.path.join(tmp, "resnet50_v1")
    net.export(prefix)
    sym, arg, aux = mx.model.load_checkpoint(prefix, 0, ctx=mx.gpu(0))
    return prefix, sym, arg, aux


def _quant_nodes(qsym):
    return [n._name for n in qsym._topo()
            if n._op in ("_contrib_quantized_conv",
                         "_contrib_quantized_fully_connected")]


def _quant_calibrate(mx, sym, arg, aux, images):
    """Naive over naive_examples and entropy over entropy_examples, on
    the card (seconds, quantized nodes); the naive run's ranges (its
    nodes' min_data/max_data) against the host's naive quantize_model
    over the same examples, with the worst share of QUANT_RANGE_RTOL."""
    from mxnet_tpu_torch.contrib import quantization as q

    c = QUANT_RESNET
    b = c["batch"]
    out = {}
    qsyms = {}
    for mode, n, ctx in (("naive", c["naive_examples"], mx.gpu(0)),
                         ("entropy", c["entropy_examples"], mx.gpu(0)),
                         ("naive_host", c["naive_examples"], mx.cpu())):
        it = mx.io.NDArrayIter(images[:n], batch_size=b, ctx=ctx)
        t0 = time.perf_counter()
        qsym, qargs, qaux = q.quantize_model(
            sym, arg, aux, ctx=ctx, calib_mode=mode.split("_")[0],
            calib_data=it, num_calib_examples=n, label_names=())
        torch.cuda.synchronize()
        out[mode] = {"seconds": time.perf_counter() - t0, "examples": n,
                     "quantized_nodes": len(_quant_nodes(qsym))}
        qsyms[mode] = (qsym, qargs, qaux)

    def ranges(qsym):
        names = set(_quant_nodes(qsym))
        return {n._name: (float(n._attrs["min_data"]),
                          float(n._attrs["max_data"]))
                for n in qsym._topo() if n._name in names}

    card, host = ranges(qsyms["naive"][0]), ranges(qsyms["naive_host"][0])
    share = 0.0 if sorted(card) == sorted(host) else math.inf
    for name, (lo, hi) in host.items():
        amax = max(abs(lo), abs(hi))
        clo, chi = card.get(name, (math.inf, math.inf))
        share = max(share, max(abs(clo - lo), abs(chi - hi))
                    / (QUANT_RANGE_RTOL * amax))
    out["range_layers"] = len(host)
    out["range_worst_share"] = share
    return out, qsyms["naive"]


def _quant_serve(mx, qprefix, fp32_prefix, images, card_line):
    """The int8 checkpoint served plain and partitioned (and the fp32
    one, for its rate): launches read just before and just after each
    served path; outputs against each other and the host's int8
    forward; img/s at b32."""
    import os

    from mxnet_tpu_torch import nd, rtc, serving
    from mxnet_tpu_torch.examples import fused_bn_relu as fb
    from mxnet_tpu_torch.ops import quantization_ops as qo

    c = QUANT_RESNET
    item, buckets = c["item"], c["buckets"]
    b = c["batch"]
    reqs = [images[:1], images[:5], images[:b]]
    res, servers, reads = {}, {}, {}
    try:
        for tag in ("plain", "partitioned"):
            if tag == "partitioned":
                os.environ["MXNET_SUBGRAPH_BACKEND"] = fb.BACKEND
            _reset_all_launches()   # the served path starts here
            g0 = qo.INT8_GEMMS
            try:
                srv = serving.InferenceServer.from_checkpoint(
                    qprefix, 0, item_shape=item, buckets=buckets,
                    max_delay_ms=5, ctx=mx.gpu(0))
            finally:
                os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
            servers[tag] = srv
            with ThreadPoolExecutor(len(reqs)) as pool:
                futs = list(pool.map(srv.submit, reqs))
            outs = [f.result(timeout=300) for f in futs]
            reads["quantization_served_" + tag] = _all_launches()
            gemms = qo.INT8_GEMMS - g0
            forwards = sum(ex.num_forwards
                           for ex in srv._model._executors.values())
            res[tag] = {"forwards": forwards, "int8_gemms": gemms,
                        "bn_relu_launches": fb.LAUNCHES,
                        "rtc_launches": rtc.LAUNCHES,
                        "compile_count": srv.compile_count,
                        "shapes_ok": [tuple(o.shape) for o in outs]
                        == [(1, 1000), (5, 1000), (b, 1000)],
                        "finite": all(bool(torch.isfinite(o.data_).all())
                                      for o in outs),
                        "b32": outs[2].data_.float().cpu().numpy()}
        # K4a per fragment, on one partitioned forward of a b32 batch
        # (after the path's reading; the b32 bucket's Executor, bound
        # partitioned): each launch against its plain version on the
        # same card input.
        fragments = []
        launch = fb.bn_relu

        def held(x, gamma, beta, mean, var, eps=1e-3, fix_gamma=True,
                 axis=1):
            got = launch(x, gamma, beta, mean, var, eps, fix_gamma, axis)
            want = fb.bn_relu_reference(x, gamma, beta, mean, var, eps,
                                        fix_gamma, axis)
            fragments.append(max_violation(
                got, want, K4A_RTOL,
                K4A_ATOL_REL * float(want.abs().max())))
            return got

        fb.bn_relu = held
        try:
            servers["partitioned"]._model(nd.array(images[:b],
                                                   ctx=mx.gpu(0)))
        finally:
            fb.bn_relu = launch
        res["k4a_fragments"] = {"held": len(fragments),
                                "worst_violation": max(fragments)}
        fp32 = serving.InferenceServer.from_checkpoint(
            fp32_prefix, 0, item_shape=item, buckets=(b,), max_delay_ms=5,
            ctx=mx.gpu(0))
        servers["fp32"] = fp32
        want = fp32.predict(images[:b]).asnumpy()
        plain, part = res["plain"]["b32"], res["partitioned"]["b32"]
        scale = float(np.abs(plain).max())

        def rel_l2(a, b):
            return float(np.linalg.norm(a - b) / np.linalg.norm(b))

        res["partitioned_vs_plain"] = {
            "rel_l2": rel_l2(part, plain),
            "max_abs_over_max_logit": float(np.abs(part - plain).max())
            / scale}
        # The host's int8 and fp32 forwards of the same checkpoints on
        # host_images images: the card's int8 logits are held against
        # the first, within the host's own int8 distance from the second.
        h = c["host_images"]
        host = {}
        t0 = time.perf_counter()
        for tag, pre in (("int8", qprefix), ("fp32", fp32_prefix)):
            sym, arg, aux = mx.model.load_checkpoint(pre, 0, ctx=mx.cpu())
            args = dict(arg, data=nd.array(images[:h], ctx=mx.cpu()))
            host[tag] = sym.bind(mx.cpu(), args, aux_states=aux,
                                 grad_req="null").forward()[0].asnumpy()
        res["host_int8_vs_fp32"] = {
            "images": h, "rel_l2": rel_l2(host["int8"], host["fp32"]),
            "top1_agreement": float(np.mean(host["int8"].argmax(1)
                                            == host["fp32"].argmax(1))),
            "host_s": time.perf_counter() - t0}
        res["card_vs_host"] = {
            "images": h, "rel_l2": rel_l2(plain[:h], host["int8"]),
            "max_abs_over_max_logit": float(np.abs(plain[:h]
                                                   - host["int8"]).max())
            / float(np.abs(host["int8"]).max()),
            "top1_agreement": float(np.mean(plain[:h].argmax(1)
                                            == host["int8"].argmax(1)))}
        res["int8_vs_fp32"] = {
            "rel_l2": rel_l2(plain, want),
            "top1_agreement": float(np.mean(plain.argmax(1)
                                            == want.argmax(1)))}
        batch = nd.array(images[:b], ctx=mx.gpu(0))
        for tag, srv in servers.items():
            ms = time_ms(lambda: srv._model(batch).wait_to_read(), iters=10)
            res.setdefault(tag, {}).update({"forward_ms_b32": ms,
                                            "img_s_b32": b * 1e3 / ms})
        for tag in ("plain", "partitioned"):
            res[tag].pop("b32")
    finally:
        for srv in servers.values():
            srv.shutdown()
    log(json.dumps({"phase": "quantization", "reading": "served",
                    "card": card_line, "served": res}))
    return res, reads


def _register_chip_ops(mx, seen):
    """The custom softmax (upstream example/numpy-ops/custom_softmax.py,
    in NDArray arithmetic; its backward p - onehot(label)) and the
    sigmoid of tests/test_contrib.py; every in_data context recorded in
    `seen`."""

    class Softmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            seen.extend(a.context for a in in_data)
            x = in_data[0]
            e = mx.nd.broadcast_sub(x, x.max(axis=1, keepdims=True)).exp()
            self.assign(out_data[0], req[0],
                        mx.nd.broadcast_div(e, e.sum(axis=1, keepdims=True)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            seen.extend(a.context for a in in_data)
            y = out_data[0]
            self.assign(in_grad[0], req[0],
                        y - mx.nd.one_hot(in_data[1], y.shape[1]))

    @mx.operator.register("chip_softmax")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            seen.append(ctx)
            return Softmax()

    class Sigmoid(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            seen.extend(a.context for a in in_data)
            y = 1.0 / (1.0 + (-in_data[0]).exp())
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1 - y))

    @mx.operator.register("chip_sigmoid")
    class SigmoidProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            seen.append(ctx)
            return Sigmoid()


def _custom_module(mx, fp32_prefix, images):
    """Part 3: ResNet-50 v1 b32 as a Module on gpu(0) with the custom
    softmax head, CUSTOM_STEPS SGD steps, each from the state it shares
    with the same Module built with SoftmaxOutput; then mx.nd.Custom
    imperatively on the card."""
    from mxnet_tpu_torch import autograd

    seen = []
    _register_chip_ops(mx, seen)
    logits = mx.sym.load(fp32_prefix + "-symbol.json")
    label = mx.sym.var("softmax_label")
    heads = {"custom": mx.sym.Custom(logits, label, op_type="chip_softmax",
                                     name="softmax"),
             "softmax_output": mx.sym.SoftmaxOutput(logits, label,
                                                    name="softmax")}
    arg, aux = mx.model.load_params(fp32_prefix, 0, ctx=mx.gpu(0))
    b = QUANT_RESNET["batch"]
    rng = np.random.default_rng(SEED + 27)
    mods = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for tag, sym in heads.items():
            m = mx.mod.Module(sym, context=mx.gpu(0),
                              label_names=["softmax_label"])
            m.bind(data_shapes=[("data", (b,) + QUANT_RESNET["item"])],
                   label_shapes=[("softmax_label", (b,))])
            m.init_params(arg_params=arg, aux_params=aux)
            m.init_optimizer(optimizer="sgd",
                             optimizer_params={"learning_rate": 0.1})
            mods[tag] = m
        errs, ms = [], {"custom": [], "softmax_output": []}
        for step in range(CUSTOM_STEPS):
            a0, x0 = mods["custom"].get_params()
            mods["softmax_output"].set_params(a0, x0)
            w0 = {k: v.asnumpy() for k, v in a0.items()}
            batch = mx.io.DataBatch(
                [mx.nd.array(images[step * b % len(images):][:b],
                             ctx=mx.gpu(0))],
                [mx.nd.array(rng.integers(0, 1000, b).astype(np.float32),
                             ctx=mx.gpu(0))])
            upd = {}
            for tag, m in mods.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m.forward_backward(batch)
                m.update()
                torch.cuda.synchronize()
                ms[tag].append((time.perf_counter() - t0) * 1e3)
                upd[tag] = {k: v.asnumpy() - w0[k]
                            for k, v in m.get_params()[0].items()}
            errs.append(_rel_l2(upd["custom"], upd["softmax_output"]))
    finally:
        torch.backends.cudnn.deterministic = det
    module_seen = list(seen)
    logits = mx.nd.array(rng.standard_normal((b, 1000)).astype(np.float32)
                         * 3, ctx=mx.gpu(0))
    label = mx.nd.array(rng.integers(0, 1000, b).astype(np.float32),
                        ctx=mx.gpu(0))
    heads = {}
    for tag in ("custom", "softmax_output"):
        x = logits.copy()
        x.attach_grad()
        with autograd.record():
            y = mx.nd.Custom(x, label, op_type="chip_softmax") \
                if tag == "custom" else mx.nd.SoftmaxOutput(x, label)
        y.backward()
        heads[tag] = {"prob": y.asnumpy(), "grad": x.grad.asnumpy()}
    head = {k: _rel_l2({"": heads["custom"][k]},
                       {"": heads["softmax_output"][k]})
            for k in ("prob", "grad")}
    seen.clear()
    x_np = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    x = mx.nd.array(x_np, ctx=mx.gpu(0))
    x.attach_grad()
    with autograd.record():
        y = mx.nd.Custom(x, op_type="chip_sigmoid")
        loss = y.sum()
    loss.backward()
    s = 1 / (1 + np.exp(-x_np.astype(np.float64)))
    sig = {"forward_rel": float(np.abs(y.asnumpy() - s).max()
                                / np.abs(s).max()),
           "grad_rel": float(np.abs(x.grad.asnumpy() - s * (1 - s)).max()
                             / np.abs(s * (1 - s)).max()),
           "on_card": bool(seen) and all(c == mx.gpu(0) for c in seen)}
    return {"update_rel_l2": errs, "limit": CUSTOM_UPDATE_REL_L2,
            "head_rel_l2": head, "head_limit": CUSTOM_HEAD_REL_L2,
            "step_ms": ms, "callbacks": len(module_seen),
            "callbacks_on_card": bool(module_seen)
            and all(c == mx.gpu(0) for c in module_seen),
            "imperative_sigmoid": sig}


def _convlstm_net(mx, ctx):
    """Three stacked Conv2DLSTMCells and a 1x1 conv to the next frame's
    channels, on `ctx`, Xavier from SEED."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.contrib import rnn as crnn

    c = CONVLSTM
    k = c["kernel"]

    class Net(gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.stack = gluon.rnn.SequentialRNNCell()
                cin = c["input"][0]
                for h in c["hidden"]:
                    self.stack.add(crnn.Conv2DLSTMCell(
                        (cin,) + c["input"][1:], h, k, k, i2h_pad=k // 2))
                    cin = h
                self.head = gluon.nn.Conv2D(c["input"][0], 1,
                                            in_channels=cin)

        def forward(self, seq):
            n, t = seq.shape[:2]
            begin = self.stack.begin_state(batch_size=n, ctx=seq.context,
                                           dtype=seq.dtype)
            out, _ = self.stack.unroll(t, seq, begin_state=begin,
                                       layout="NTC", merge_outputs=True)
            return self.head(out.reshape((n * t,) + out.shape[2:]))

    mx.random.seed(SEED)
    net = Net()
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def _loss_step(net, args, target, trainer=None, batch=None):
    from mxnet_tpu_torch import autograd

    with autograd.record():
        loss = ((net(*args) - target) ** 2).mean()
    loss.backward()
    if trainer is not None:
        trainer.step(batch)
    return float(loss.asnumpy())


def _grads_of(net):
    from mxnet_tpu_torch.gluon.utils import relative_names

    params = net.collect_params()
    rel = relative_names(list(params.keys()), net.prefix)
    return {rel[n]: p.grad().asnumpy().astype(np.float64)
            for n, p in params.items() if p.grad_req != "null"}


def _f64_twin(mx, net, make):
    """`make(ctx)` on the host with `net`'s weights, then cast to
    float64 (a float64 array set through nd.array would narrow)."""
    from mxnet_tpu_torch.gluon.utils import params_from_numpy

    host = make(mx.cpu())
    params_from_numpy(host, {n: p.data().asnumpy() for n, p in
                             net.collect_params().items()},
                      prefix=net.prefix)
    host.cast("float64")
    return host


def _convlstm(mx):
    """Part 4a: the ConvLSTM trained CONVLSTM["steps"] SGD steps on the
    card; one step's gradients at parity_batch against the host's
    float64."""
    from mxnet_tpu_torch import gluon

    c = CONVLSTM
    rng = np.random.default_rng(SEED + 28)
    shape = (c["batch"], c["frames"]) + c["input"]
    seq = rng.random(shape, dtype=np.float32)
    target = rng.random((c["batch"] * c["frames"],) + c["input"],
                        dtype=np.float32)
    net = _convlstm_net(mx, mx.gpu(0))
    p = c["parity_batch"]
    xs = mx.nd.array(seq[:p], ctx=mx.gpu(0))
    ts = mx.nd.array(target[:p * c["frames"]], ctx=mx.gpu(0))
    host = _f64_twin(mx, net, lambda ctx: _convlstm_net(mx, ctx))
    _loss_step(net, (xs,), ts)
    card = _grads_of(net)
    t0 = time.perf_counter()
    _loss_step(host, (mx.nd.array(seq[:p], ctx=mx.cpu(), dtype="float64"),),
               mx.nd.array(target[:p * c["frames"]], ctx=mx.cpu(),
                           dtype="float64"))
    host_s = time.perf_counter() - t0
    want = _grads_of(host)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": c["lr"]})
    x = mx.nd.array(seq, ctx=mx.gpu(0))
    t = mx.nd.array(target, ctx=mx.gpu(0))
    losses, ms = [], []
    for _ in range(c["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(_loss_step(net, (x,), t, trainer, c["batch"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"losses": losses, "step_ms": ms, "f64_rel_l2": _rel_l2(card,
                                                                    want),
            "f64_worst_tensor": max(_rel_max(card, want).values()),
            "host_f64_s": host_s, "limit": CONTRIB_F64_REL_L2}


def _lstmp_nce_net(mx, ctx, vocab, drop):
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.contrib import loss as closs
    from mxnet_tpu_torch.gluon.contrib import rnn as crnn

    c = LSTMP_NCE

    class Net(gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.cell = crnn.VariationalDropoutCell(
                    crnn.LSTMPCell(c["hidden"], c["proj"],
                                   input_size=c["proj"]),
                    drop_inputs=drop, drop_states=drop, drop_outputs=drop)
                self.weight = self.params.get(
                    "weight", shape=(vocab, c["proj"]),
                    init=mx.init.Normal(0.05))
                self.bias = self.params.get("bias", shape=(vocab,),
                                            init="zeros")
                self.nce = closs.NCELoss(c["noise"], vocab)

        def hidden(self, tokens):
            w = self.weight.data(tokens.context)
            emb = mx.nd.take(w, tokens)             # tied input embedding
            begin = self.cell.begin_state(batch_size=tokens.shape[0],
                                          ctx=emb.context, dtype=emb.dtype)
            out, _ = self.cell.unroll(tokens.shape[1], emb,
                                      begin_state=begin, layout="NTC",
                                      merge_outputs=True)
            return out

        def forward(self, tokens, labels, noise):
            out = self.hidden(tokens)
            ctx = tokens.context
            return self.nce(out.reshape((-1, c["proj"])),
                            self.weight.data(ctx), self.bias.data(ctx),
                            labels.reshape((-1,)),
                            noise.reshape((-1, c["noise"]))).mean()

    mx.random.seed(SEED)
    net = Net()
    net.initialize(mx.init.Xavier(), ctx=ctx)
    return net


def _nce_batch(mx, rng, vocab, batch, ctx, dtype="float32"):
    """(tokens, next tokens, noise ids) of one LM batch, as arrays."""
    c = LSTMP_NCE
    tok = rng.integers(0, vocab, (batch, c["T"] + 1))
    noise = rng.integers(0, vocab, (batch, c["T"], c["noise"]))
    return tuple(mx.nd.array(a.astype(np.float64), ctx=ctx, dtype=dtype)
                 for a in (tok[:, :-1], tok[:, 1:], noise))


def _lstmp_nce(mx):
    """Part 4b: LSTM-2048-512 under VariationalDropoutCell into NCELoss
    over the One Billion Word table on the card (step ms, peak bytes,
    one mask across time); one step at drop rate 0 against the host's
    float64 at parity_vocab rows."""
    from mxnet_tpu_torch import autograd, gluon

    c = LSTMP_NCE
    rng = np.random.default_rng(SEED + 29)
    out = {}
    net = _lstmp_nce_net(mx, mx.gpu(0), c["parity_vocab"], 0.0)
    host = _f64_twin(mx, net, lambda ctx: _lstmp_nce_net(
        mx, ctx, c["parity_vocab"], 0.0))
    batch = _nce_batch(mx, rng, c["parity_vocab"], c["parity_batch"],
                      mx.cpu(), "float64")
    with autograd.record():
        net(*[a.astype("float32").as_in_context(mx.gpu(0))
              for a in batch]).backward()
    card = _grads_of(net)
    t0 = time.perf_counter()
    with autograd.record():
        host(*batch).backward()
    out["host_f64_s"] = time.perf_counter() - t0
    want = _grads_of(host)
    out["f64_rel_l2"] = _rel_l2(card, want)
    out["f64_worst_tensor"] = max(_rel_max(card, want).values())
    out["limit"] = CONTRIB_F64_REL_L2
    del net, host
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    net = _lstmp_nce_net(mx, mx.gpu(0), c["vocab"], c["drop"])
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": c["lr"]})
    losses, ms = [], []
    for _ in range(c["steps"]):
        toks, labels, noise = _nce_batch(mx, rng, c["vocab"], c["batch"],
                                        mx.gpu(0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with autograd.record():
            loss = net(toks, labels, noise)
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
        ms.append((time.perf_counter() - t0) * 1e3)
    out.update({"losses": losses, "step_ms": ms,
                "table_bytes": c["vocab"] * c["proj"] * 4,
                "peak_bytes": torch.cuda.max_memory_allocated() - base})
    with autograd.record():
        h = net.hidden(toks).asnumpy()             # (N, T, 512)
    zero = h == 0
    state_mask = net.cell._state_mask
    out["masks"] = {
        "output_zero_share": float(zero.mean()),
        "output_same_every_step": bool((zero == zero[:, :1]).all()),
        "state_mask_values": sorted(set(np.unique(
            state_mask.asnumpy()).round(6).tolist()))
        if state_mask is not None else None}
    return out


def _sparse_embedding(mx):
    """Part 4c: SparseEmbedding at phase 25's user count: one
    gluon.Trainer Adam step moves exactly the batch's rows, and their
    moments; every other row bit for bit."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.contrib import nn as cnn

    args = _mf_args()
    data = _mf_data(args)
    mx.random.seed(SEED)
    net = cnn.SparseEmbedding(args.num_users, args.rank)
    net.initialize(mx.init.Normal(0.1), ctx=mx.gpu(0))
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": args.lr})
    u, _, r = _mf_batches(mx, data, args, mx.gpu(0), 1)[0]
    before = _mf_state(net)
    with autograd.record():
        loss = ((net(u).sum(axis=1) - r) ** 2).sum()
    loss.backward()
    trainer.step(u.shape[0])
    after, moments = _mf_state(net), _mf_moments(net, trainer)
    rows = np.unique(data[0][:args.batch_size].astype(np.int64))
    (name, w0), = before.items()
    changed = np.nonzero((after[name] != w0).any(axis=1))[0]
    rest = np.setdiff1d(np.arange(w0.shape[0]), rows)
    return {"rows": int(rows.size), "changed": int(changed.size),
            "changed_are_batch": bool(np.array_equal(changed, rows)),
            "moments_are_batch": all(
                np.array_equal(np.nonzero((m != 0).any(axis=1))[0], rows)
                for m in moments[name]),
            "rest_bit_for_bit": bool(np.array_equal(after[name][rest],
                                                    w0[rest])),
            "grad_stype": net.weight.grad_stype}


def phase_quantization_contrib(card_line):
    """Phase 26 (see the module docstring). Returns its launch counts by
    path."""
    import os
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx

    t_phase = time.perf_counter()
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    read = {"phase": "quantization", "card": card_line}
    reads = {}

    def reading(name, value):
        read[name] = value
        log(json.dumps({"phase": "quantization", "reading": name,
                        "card": card_line, name: value}))

    _reset_all_launches()   # the LeNet path starts here
    reading("lenet", _quant_lenet(mx))
    reads["quantization_lenet"] = _all_launches()   # read just after
    tmp = tempfile.mkdtemp(prefix="quant-", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "mxnet_tpu_torch",
        "_build"))
    try:
        prefix, sym, arg, aux = _quant_export(mx, tmp)
        rng = np.random.default_rng(SEED + 26)
        images = rng.random((QUANT_RESNET["naive_examples"],)
                            + QUANT_RESNET["item"], dtype=np.float32)
        _reset_all_launches()   # the calibration path starts here
        calib, (qsym, qargs, qaux) = _quant_calibrate(mx, sym, arg, aux,
                                                      images)
        reads["quantization_calibrate"] = _all_launches()
        reading("calibration", calib)
        qprefix = os.path.join(tmp, "resnet50_v1_int8")
        mx.model.save_checkpoint(qprefix, 0, qsym, qargs, qaux)
        with open(qprefix + "-0000.params", "rb") as f:
            blob = f.read()
        int8_names = sorted(n for n in qargs if str(qargs[n].dtype) == "int8")
        reading("checkpoint", {
            "int8_params": len(int8_names),
            "params_bytes": len(blob),
            "int8_loaded": all(
                str(v.dtype) == "int8" for k, v in
                mx.model.load_checkpoint(qprefix, 0, ctx=mx.cpu())[1].items()
                if k in int8_names)})
        served, served_reads = _quant_serve(mx, qprefix, prefix, images,
                                            card_line)
        read["served"] = served
        reads.update(served_reads)
        _reset_all_launches()   # the custom-op path starts here
        reading("custom_op", _custom_module(mx, prefix, images))
        reads["custom_op_module"] = _all_launches()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _reset_all_launches()   # the gluon.contrib path starts here
    reading("convlstm", _convlstm(mx))
    reading("lstmp_nce", _lstmp_nce(mx))
    reading("sparse_embedding", _sparse_embedding(mx))
    reads["gluon_contrib"] = _all_launches()
    read["launches"] = reads
    read["seconds"] = time.perf_counter() - t_phase
    log(json.dumps(read, default=str))

    le = read["lenet"]
    check(le["fp32_accuracy"] > QUANT_LENET["min_fp32"],
          "quantization: LeNet fp32 accuracy %.3f" % le["fp32_accuracy"])
    check(abs(le["fp32_accuracy"] - le["int8_accuracy"])
          <= QUANT_LENET["max_drop"] + 1e-9,
          "quantization: LeNet int8 %.3f against fp32 %.3f"
          % (le["int8_accuracy"], le["fp32_accuracy"]))
    check(le["int8_dtypes"] == ["int8"] and len(le["quantized_weights"]) == 3
          and le["int8_gemms"] == 3 * le["forwards"] > 0
          and le["batches_on_card"], "quantization: LeNet %s" % le)
    ca = read["calibration"]
    check(all(ca[m]["quantized_nodes"] == QUANT_NODES
              for m in ("naive", "entropy", "naive_host"))
          and ca["range_layers"] == QUANT_NODES,
          "quantization: quantized nodes %s" % ca)
    check(ca["range_worst_share"] <= 1.0, "quantization: card ranges "
          "against the host's at %.3f of their limit" %
          ca["range_worst_share"])
    ck = read["checkpoint"]
    check(ck["int8_params"] == QUANT_NODES and ck["int8_loaded"],
          "quantization: the int8 checkpoint %s" % ck)
    for tag in ("plain", "partitioned"):
        s = served[tag]
        per = QUANT_K4A_PER_FORWARD if tag == "partitioned" else 0
        check(s["shapes_ok"] and s["finite"]
              and s["compile_count"] == len(QUANT_RESNET["buckets"]),
              "quantization: served %s %s" % (tag, s))
        check(s["int8_gemms"] == QUANT_NODES * s["forwards"] > 0,
              "quantization: %s ran %d int8 GEMMs in %d forwards"
              % (tag, s["int8_gemms"], s["forwards"]))
        check(s["bn_relu_launches"] == s["rtc_launches"]
              == per * s["forwards"], "quantization: %s K4a/K4 launches "
              "%d/%d in %d forwards" % (tag, s["bn_relu_launches"],
                                        s["rtc_launches"], s["forwards"]))
    frags = served["k4a_fragments"]
    check(frags["held"] == QUANT_K4A_PER_FORWARD
          and frags["worst_violation"] <= 0, "quantization: K4a against "
          "its plain version in the int8 forward: %s" % frags)
    limit = served["host_int8_vs_fp32"]["rel_l2"]
    for key in ("partitioned_vs_plain", "card_vs_host"):
        check(served[key]["rel_l2"] <= limit,
              "quantization: %s at relative L2 %g, above the host's int8 "
              "distance from fp32, %g" % (key, served[key]["rel_l2"], limit))
    check(served["card_vs_host"]["top1_agreement"] == 1.0,
          "quantization: card int8 top-1 against the host's %s"
          % served["card_vs_host"])
    co = read["custom_op"]
    check(max(co["head_rel_l2"].values()) <= CUSTOM_HEAD_REL_L2,
          "custom op: the head against SoftmaxOutput's %s (limit %g)"
          % (co["head_rel_l2"], CUSTOM_HEAD_REL_L2))
    check(max(co["update_rel_l2"]) <= CUSTOM_UPDATE_REL_L2,
          "custom op: updates against SoftmaxOutput's %s (limit %g)"
          % (co["update_rel_l2"], CUSTOM_UPDATE_REL_L2))
    check(co["callbacks_on_card"] and co["callbacks"] > 0,
          "custom op: a callback saw an array off the card")
    sg = co["imperative_sigmoid"]
    check(sg["forward_rel"] <= 1e-5 and sg["grad_rel"] <= 1e-5
          and sg["on_card"], "custom op: imperative sigmoid %s" % sg)
    for name in ("convlstm", "lstmp_nce"):
        r = read[name]
        check(all(math.isfinite(v) for v in r["losses"]),
              "%s: a loss is not finite: %s" % (name, r["losses"]))
        check(r["f64_rel_l2"] <= CONTRIB_F64_REL_L2,
              "%s: card fp32 against host float64 at relative L2 %g "
              "(limit %g)" % (name, r["f64_rel_l2"], CONTRIB_F64_REL_L2))
    mk = read["lstmp_nce"]["masks"]
    keep = 1.0 / (1.0 - LSTMP_NCE["drop"])
    check(mk["output_same_every_step"]
          and 0.5 * LSTMP_NCE["drop"] < mk["output_zero_share"]
          < 1.5 * LSTMP_NCE["drop"]
          and mk["state_mask_values"] == [0.0, round(keep, 6)],
          "lstmp: dropout masks %s" % mk)
    se = read["sparse_embedding"]
    check(se["changed_are_batch"] and se["moments_are_batch"]
          and se["rest_bit_for_bit"] and se["grad_stype"] == "row_sparse",
          "SparseEmbedding: %s" % se)
    for path, launches in reads.items():
        expect = {"bn_relu": 0, "rtc": 0}
        if path == "quantization_served_partitioned":
            n = QUANT_K4A_PER_FORWARD * served["partitioned"]["forwards"]
            expect = {"bn_relu": n, "rtc": n}
        check(launches["bn_relu"] == expect["bn_relu"]
              and launches["rtc"] == expect["rtc"]
              and launches["k1_k2_k3"] == (0, 0, 0)
              and launches["scale_add"] == launches["relu"] == 0
              and not any(launches["d1_d2"]),
              "quantization: launches on %s: %s" % (path, launches))
    return reads


# -- slice 23: the toolkit -----------------------------------------------------

# Part 1: upstream example/svrg_module's linear regression over
# YearPredictionMSD (90 features, one output): 65 536 synthetic rows from
# the seed, a cut from the dataset's 463 715 training rows.
SVRG_MSD = {"features": 90, "rows": 65536, "dataset_rows": 463715,
            "batch": 128, "epochs": 4, "update_freq": 2, "lr": 0.05}
SVRG_FULL_REL_L2 = 1e-5        # stored full gradient vs the batch mean
SVRG_FIRST_REL_L2 = 1e-6       # first corrected gradient vs the full one
SVRG_CORRECTED_REL_L2 = 1e-5   # a corrected gradient vs float64 on the host
# Part 2: glove.840B.300d's width, 100 000 synthetic tokens, and a second
# file at 50; a synthetic corpus over them with unknown words.
TEXT = {"tokens": 100000, "dims": (300, 50), "corpus_tokens": 1000000,
        "oov_share": 0.05, "probe_tokens": 4096}
# Part 3: the oracles over nd.contrib.flash_attention in fp32. The
# finite differences step by 1e-2, not check_numeric_gradient's default
# 1e-3: the sum of the op's output is accurate to about 2^-20 of each
# term under K1's split TF32 (fp32 alone: a few ulps of the sum), and
# at 1e-3 that rounding over 2 eps is near the atol of 1e-3 (an H100
# 80GB HBM3 at 700 W: 2.4e-3 off at an entry of 4.3e-4; the host's fp32
# plain version 2.55e-3 off at (1, 1, 16, 64), tests/torch_parity_probes.py
# fd_noise); 1e-2 balances it against the central difference's eps^2
# error. rtol and atol stay the defaults.
ORACLE = {"consistency": (1, 16, 1024, 64), "gradient": (1, 1, 16, 32),
          "eps": 1e-2, "speed": (8, 16, 2048, 64), "speed_n": 10}
ORACLE_GRAD_REL_L2 = 2e-4      # card autograd vs the host's float64
# Part 4: phase 15's ResNet-50 v1 Module at b32, 3 batches a run.
MONITOR = {"batch": 32, "batches": 3, "item": (3, 224, 224)}
MONITOR_STAT_RTOL = 1e-6
# Part 5: the file tools on 512 synthetic 224x224 PNGs in 8 classes.
FILE_TOOLS = {"images": 512, "classes": 8, "side": 224, "shards": 4,
              "steps": 4, "batch": 32, "network": "resnet50",
              "outputs": 1000}


def _linreg_sym(mx):
    data = mx.sym.var("data")
    out = mx.sym.FullyConnected(data, num_hidden=1, name="fc")
    return mx.sym.LinearRegressionOutput(out, name="lin_reg")


def _epoch_rate(mod, it, limit=None):
    """Batches/s of one pass of forward, backward and update over `it`
    (its first `limit` batches), the card synchronized at both ends."""
    it.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for batch in it:
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        n += 1
        if n == limit:
            break
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def _toolkit_svrg(mx):
    """Part 1: SVRGModule over the linear regression on gpu(0)."""
    from mxnet_tpu_torch.contrib.svrg_optimization import SVRGModule

    c = SVRG_MSD
    ctx = mx.gpu(0)
    rng = np.random.default_rng(SEED + 27)
    X = rng.standard_normal((c["rows"], c["features"]), dtype=np.float32)
    w_true = rng.standard_normal(c["features"]) / np.sqrt(c["features"])
    y = (X @ w_true + 0.1 * rng.standard_normal(c["rows"])).astype(
        np.float32)[:, None]
    train = mx.io.NDArrayIter(X, y, batch_size=c["batch"], shuffle=False,
                              label_name="lin_reg_label", ctx=ctx)
    mod = SVRGModule(_linreg_sym(mx), data_names=("data",),
                     label_names=("lin_reg_label",),
                     update_freq=c["update_freq"], context=ctx)
    mse, ends = [], []
    X64, y64 = X.astype(np.float64), y.astype(np.float64)

    def on_epoch(epoch, sym, arg, aux):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        w = arg["fc_weight"].asnumpy().astype(np.float64)
        b = arg["fc_bias"].asnumpy().astype(np.float64)
        mse.append(float(np.mean((X64 @ w.T + b - y64) ** 2)))
        ends[-1] = (ends[-1], time.perf_counter())

    t0 = time.perf_counter()
    mod.fit(train, num_epoch=c["epochs"], optimizer="sgd",
            optimizer_params={"learning_rate": c["lr"]}, eval_metric="mse",
            epoch_end_callback=on_epoch)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    out = {"rows": c["rows"], "rows_cut_from": c["dataset_rows"],
           "features": c["features"], "batch": c["batch"],
           "epochs": c["epochs"], "update_freq": c["update_freq"],
           "mse_by_epoch": mse, "fit_seconds": fit_s}
    # An SVRG epoch without a full pass (epochs 1 and 3 of update_freq
    # 2): from the end of the epoch before, the host's MSE excluded.
    nb = c["rows"] // c["batch"]
    spans = [ends[e][0] - ends[e - 1][1] for e in range(1, c["epochs"])
             if e % c["update_freq"]]
    out["svrg_batches_s"] = nb / float(np.median(spans))
    names = mod._param_names
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.update_full_grads(train)
    torch.cuda.synchronize()
    out["full_gradient_pass_s"] = time.perf_counter() - t0
    full = {n: mod._param_dict[n].asnumpy().astype(np.float64)
            for n in names}
    out["full_on_card"] = all(mod._param_dict[n].context == ctx
                              for n in names)
    # (a) The stored full gradient against the mean of the per-batch
    # gradients at the snapshot, accumulated on the host in float64.
    train.reset()
    acc = {n: 0.0 for n in names}
    nb = 0
    for batch in train:
        mod._mod_aux.forward(batch, is_train=True)
        mod._mod_aux.backward()
        for n in names:
            acc[n] = acc[n] + mod._mod_aux._execs[0].grad_dict[
                n].asnumpy().astype(np.float64)
        nb += 1
    out["full_vs_batch_mean_rel_l2"] = _rel_l2(
        full, {n: acc[n] / nb for n in names})
    # (b) The first update after the snapshot: g(w, b) - g(w~, b) is 0.
    train.reset()
    batches = iter(train)
    mod.forward(next(batches), is_train=True)
    mod.backward()
    mod._update_svrg_gradients()
    out["first_vs_full_rel_l2"] = _rel_l2(
        {n: mod._execs[0].grad_dict[n].asnumpy() for n in names}, full)
    mod.update()
    # (c) A corrected gradient away from the snapshot against the host's
    # float64 formula on the same buffers.
    mod.forward(next(batches), is_train=True)
    mod.backward()
    host = {n: mod._execs[0].grad_dict[n].asnumpy().astype(np.float64)
            - mod._mod_aux._execs[0].grad_dict[n].asnumpy().astype(
                np.float64) + full[n] for n in names}
    mod._update_svrg_gradients()
    out["corrected_vs_host_f64_rel_l2"] = _rel_l2(
        {n: mod._execs[0].grad_dict[n].asnumpy() for n in names}, host)
    out["grads_on_card"] = all(
        ex.grad_dict[n].context == ctx for n in names
        for ex in mod._execs + mod._mod_aux._execs)
    # Reading: a plain Module epoch over the same batches, beside the SVRG
    # epoch's (two executors a batch).
    plain = mx.mod.Module(_linreg_sym(mx), data_names=("data",),
                          label_names=("lin_reg_label",), context=ctx)
    plain.bind(data_shapes=train.provide_data,
               label_shapes=train.provide_label)
    plain.init_params()
    plain.init_optimizer(optimizer="sgd",
                         optimizer_params={"learning_rate": c["lr"]})
    _epoch_rate(plain, train, limit=16)         # warm
    out["module_batches_s"] = _epoch_rate(plain, train)
    out["batches_per_epoch"] = nb
    return out


def _write_glove(path, tokens, dim, rng):
    """A GloVe-format text file: token and `dim` signed values of three
    decimals a line ("+0.123"), built as bytes in numpy. Returns nothing;
    the loader's matrix is what is compared."""
    levels = np.frombuffer("".join(
        "%+.3f " % (k / 1000.0) for k in range(-2000, 2001)).encode(),
        np.uint8).reshape(-1, 7)
    width = len(tokens[0]) + 1
    with open(path, "wb") as f:
        for s in range(0, len(tokens), 8192):
            n = min(8192, len(tokens) - s)
            rows = levels[rng.integers(0, len(levels), (n, dim))].reshape(
                n, dim * 7)
            rows[:, -1] = ord("\n")
            heads = np.frombuffer("".join(
                t + " " for t in tokens[s:s + n]).encode(),
                np.uint8).reshape(n, width)
            f.write(np.concatenate([heads, rows], axis=1).tobytes())


def _toolkit_text(mx, tmp):
    """Part 2: contrib.text at a published width on gpu(0)."""
    import os

    from mxnet_tpu_torch.contrib import text

    c = TEXT
    ctx = mx.gpu(0)
    rng = np.random.default_rng(SEED + 28)
    tokens = ["tok%06d" % i for i in range(c["tokens"])]
    paths = [os.path.join(tmp, "glove.840B.300d.txt"),
             os.path.join(tmp, "vectors.50d.txt")]
    t0 = time.perf_counter()
    for path, dim in zip(paths, c["dims"]):
        _write_glove(path, tokens, dim, rng)
    out = {"tokens": c["tokens"], "dims": list(c["dims"]),
           "write_s": time.perf_counter() - t0,
           "file_bytes": [os.path.getsize(p) for p in paths]}
    t0 = time.perf_counter()
    glove = text.embedding.GloVe(pretrained_file_path=paths[0])
    out["load_s_300d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    custom = text.embedding.CustomEmbedding(paths[1])
    out["load_s_50d"] = time.perf_counter() - t0
    # A Zipf-like corpus over the file's tokens with unknown words mixed in.
    n = c["corpus_tokens"]
    ranks = np.minimum(rng.zipf(1.2, n), c["tokens"]) - 1
    words = [tokens[r] for r in ranks]
    for i in np.flatnonzero(rng.random(n) < c["oov_share"]):
        words[i] = "oov%05d" % (i % 20000)
    corpus = "\n".join(" ".join(words[s:s + 20])
                       for s in range(0, n, 20))
    t0 = time.perf_counter()
    counter = text.utils.count_tokens_from_str(corpus)
    vocab = text.Vocabulary(counter, reserved_tokens=["<pad>"])
    comp = text.embedding.CompositeEmbedding(vocab, [glove, custom])
    out["vocab_and_composite_s"] = time.perf_counter() - t0
    out["vocab"] = len(vocab)
    out["composite_vec_len"] = comp.vec_len
    checks = {}
    for tag, emb in (("glove", glove), ("custom", custom),
                     ("composite", comp)):
        v = emb.idx_to_vec
        checks[tag + "_on_card"] = v.context == ctx
        checks[tag + "_bit_for_bit"] = bool(np.array_equal(
            v.asnumpy(), emb._idx_to_vec))
        out["matrix_bytes_" + tag] = int(emb._idx_to_vec.nbytes)
    probe = [vocab.idx_to_token[i] for i in rng.integers(
        0, len(vocab), c["probe_tokens"])] + ["never-seen", "oov99999"]
    got = comp.get_vecs_by_tokens(probe)
    want = comp._idx_to_vec[[comp.token_to_idx.get(t, 0) for t in probe]]
    checks["vecs_on_card"] = got.context == ctx
    checks["vecs_bit_for_bit"] = bool(np.array_equal(got.asnumpy(), want))
    layer = mx.gluon.nn.Embedding(len(comp), comp.vec_len)
    layer.initialize(ctx=ctx)
    layer.weight.set_data(comp.idx_to_vec)
    ids = comp.to_indices(probe)
    rows = layer(mx.nd.array(ids, ctx=ctx))
    checks["embedding_on_card"] = rows.context == ctx
    checks["embedding_bit_for_bit"] = bool(np.array_equal(
        rows.asnumpy(), comp._idx_to_vec[ids]))
    out["checks"] = checks
    return out


def _toolkit_oracles(mx, card_line, kernel_ms):
    """Part 3: test_utils' oracles over nd.contrib.flash_attention on the
    card in fp32, K1-K3 launched through them."""
    from mxnet_tpu_torch import test_utils
    from mxnet_tpu_torch.ops import flash_attention as fa

    c = ORACLE
    rng = np.random.default_rng(SEED + 29)
    out = {}
    qkv = [rng.uniform(-1, 1, c["consistency"]).astype(np.float32)
           for _ in range(3)]
    want = fa.flash_attention_reference(*(torch.from_numpy(a)
                                          for a in qkv))[0]
    rtol, atol = fa.kernel_tolerance(torch.float32, want)

    def attend(q, k, v):
        return mx.nd.contrib.flash_attention(q, k, v)

    t0 = time.perf_counter()
    outs = test_utils.check_consistency(attend, qkv,
                                        ctx_list=[mx.cpu(0), mx.gpu(0)],
                                        rtol=rtol, atol=atol)
    out["consistency"] = {
        "shape": list(c["consistency"]), "rtol": rtol, "atol": atol,
        "max_abs_err": float(np.abs(outs[1] - outs[0]).max()),
        "worst_share": float((np.abs(outs[1] - outs[0])
                              / (atol + rtol * np.abs(outs[0]))).max()),
        "seconds": time.perf_counter() - t0}
    small = [rng.uniform(-1, 1, c["gradient"]).astype(np.float32)
             for _ in range(3)]
    t0 = time.perf_counter()
    test_utils.check_numeric_gradient(attend, small, eps=c["eps"],
                                      ctx=mx.gpu(0))
    out["numeric_gradient"] = {"shape": list(c["gradient"]), "rtol": 1e-2,
                               "atol": 1e-3, "eps": c["eps"],
                               "passed": True,
                               "seconds": time.perf_counter() - t0}
    # The card's autograd (K2, K3) against the host's float64 autograd
    # of the plain version on the same inputs.
    card = [mx.nd.array(a, ctx=mx.gpu(0)) for a in small]
    for a in card:
        a.attach_grad()
    with mx.autograd.record():
        attend(*card).sum().backward()
    host = [torch.from_numpy(a).double().requires_grad_() for a in small]
    fa.flash_attention_reference(*host)[0].sum().backward()
    out["numeric_gradient"]["card_vs_host_f64_rel_l2"] = _rel_l2(
        {i: a.grad.asnumpy() for i, a in enumerate(card)},
        {i: h.grad.numpy() for i, h in enumerate(host)})
    q, k, v = (mx.sym.var(n) for n in "qkv")
    sym = mx.sym.contrib.flash_attention(q, k, v, causal=True)
    shape = c["speed"]
    speed = {}
    for typ in ("whole", "forward"):
        speed[typ + "_ms"] = 1e3 * test_utils.check_speed(
            sym, ctx=mx.gpu(0), N=c["speed_n"], typ=typ, q=shape, k=shape,
            v=shape)
    speed["kernels_device_ms"] = kernel_ms
    speed["kernels_device_ms_sum"] = sum(kernel_ms.values())
    speed["shape"] = list(shape)
    speed["causal"] = True
    out["speed"] = speed
    return out


def _recording_monitor(mx):
    """A ``Monitor(1, pattern=".*")`` whose ``toc_print`` keeps each
    batch's ``toc()`` rows with the executors' outputs copied to the
    host."""
    class Recording(mx.monitor.Monitor):
        def __init__(self):
            super().__init__(1, pattern=".*")
            self.rows = []

        def toc_print(self):
            res = self.toc()
            outs = {}
            for exe in self.exes:
                for name, o in zip(exe.output_names, exe.outputs):
                    outs[name] = o.asnumpy()
            self.rows.append((res, outs))

    return Recording()


def _toolkit_monitor_viz(mx, tmp):
    """Part 4: Monitor through Module.fit and the visualization of phase
    15's ResNet-50 v1 symbol, on gpu(0)."""
    import contextlib
    import io

    c = MONITOR
    ctx = mx.gpu(0)
    net = _resnet50(seed=SEED)
    sym, arg, aux = _module_symbol(net, tmp)
    del net
    rng = np.random.default_rng(SEED + 30)
    n = c["batch"] * c["batches"]
    xs = rng.random((n,) + c["item"], dtype=np.float32)
    ys = rng.integers(0, 10, n).astype(np.float32)
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", (c["batch"],) + c["item"])],
             label_shapes=[("softmax_label", (c["batch"],))])
    mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(TRAINER_OPT))

    def fit(monitor=None):
        it = mx.io.NDArrayIter(xs, ys, batch_size=c["batch"], ctx=ctx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=1, monitor=monitor)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / c["batches"]

    fit()                                       # warm
    mon = _recording_monitor(mx)
    out = {"step_ms_monitor": fit(mon), "step_ms_plain": fit()}
    out["step_ms_monitor_again"] = fit(_recording_monitor(mx))
    names = list(mod.output_names)
    out["reported"] = [[name for _, name, _ in res] for res, _ in mon.rows]
    out["every_output_every_batch"] = len(mon.rows) == c["batches"] and all(
        sorted(r) == sorted(names) for r in out["reported"])
    worst = 0.0
    for res, outs in mon.rows:
        for _, name, stat in res:
            got = float(stat.strip("[]").split()[0])
            want = float(np.abs(outs[name].astype(np.float64)).mean())
            worst = max(worst, abs(got - want) / max(abs(want), 1e-30))
    out["stat_worst_rel"] = worst
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        total = mx.viz.print_summary(
            sym, shape={"data": (c["batch"],) + c["item"]})
    arg_now, _ = mod.get_params()
    out["summary_total_params"] = total
    out["module_params"] = int(sum(int(np.prod(v.shape))
                                   for v in arg_now.values()))
    out["summary_lines"] = len(buf.getvalue().splitlines())
    plot = mx.viz.plot_network(sym, title="resnet50_v1")
    dot = getattr(plot, "source", plot)
    hidden = ("_weight", "_bias", "_gamma", "_beta", "_moving_mean",
              "_moving_var")
    missing = [node._name for node in sym._topo()
               if node._name and node._op != "_group"
               and not (node._op is None and node._name.endswith(hidden))
               and '"%s' % node._name not in dot]
    out["dot_bytes"] = len(dot)
    out["dot_missing_nodes"] = missing[:10]
    out["dot_names_every_node"] = not missing
    return out


def _png_tree(root, rng):
    """FILE_TOOLS["images"] smooth 224x224 BGR images with noise, written
    as PNG (the port's codec) into FILE_TOOLS["classes"] class folders.
    Returns {relative path: pixels}."""
    import os

    from mxnet_tpu_torch.image import png

    c = FILE_TOOLS
    side = c["side"]
    ramp = np.linspace(0, 255, side, dtype=np.float32)
    images = {}
    for i in range(c["images"]):
        cls = "class%d" % (i % c["classes"])
        os.makedirs(os.path.join(root, cls), exist_ok=True)
        base = (ramp[None, :, None] * rng.random(3) + ramp[:, None, None]
                * rng.random(3)) / 2
        img = np.clip(base + rng.integers(0, 16, (side, side, 3)), 0,
                      255).astype(np.uint8)
        rel = os.path.join(cls, "img%04d.png" % i)
        with open(os.path.join(root, rel), "wb") as f:
            f.write(png.encode(img))
        images[rel] = img
    return images


def _run_tool(args):
    """``python -m mxnet_tpu_torch.tools.<...>``: (seconds, stdout)."""
    import os

    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m"] + args, capture_output=True,
                         text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    check(res.returncode == 0, "%s exited %d: %s"
          % (" ".join(args[:1]), res.returncode, res.stderr[-2000:]))
    return time.perf_counter() - t0, res.stdout


def _toolkit_file_tools(mx, tmp):
    """Part 5: the RecordIO file tools over a PNG tree, then TrainStep
    fed from the shards."""
    import os

    from mxnet_tpu_torch import recordio
    from mxnet_tpu_torch.data import RecordDataset
    from mxnet_tpu_torch.examples import train_imagenet
    from mxnet_tpu_torch.tools import im2rec, rec2idx, rec_shard

    c = FILE_TOOLS
    rng = np.random.default_rng(SEED + 31)
    root = os.path.join(tmp, "images")
    t0 = time.perf_counter()
    images = _png_tree(root, rng)
    out = {"images": c["images"], "classes": c["classes"],
           "write_s": time.perf_counter() - t0}
    try:
        import cv2  # noqa: F401
        out["cv2"] = True
    except ImportError:
        out["cv2"] = False
    prefix = os.path.join(tmp, "train")
    # --list, rec2idx and rec_shard through their mains in this process;
    # the pack runs as ``python -m`` (a child costs 5-15 s of imports).
    t0 = time.perf_counter()
    im2rec.main([prefix, root, "--list"])
    out["list_s"] = time.perf_counter() - t0
    out["pack_s"], _ = _run_tool(["mxnet_tpu_torch.tools.im2rec", prefix,
                                  root, "--encoding", ".png"])
    out["pack_images_s"] = c["images"] / out["pack_s"]
    t0 = time.perf_counter()
    rec2idx.main([prefix + ".rec", prefix + ".rebuilt.idx"])
    out["index_s"] = time.perf_counter() - t0
    with open(prefix + ".idx", "rb") as a, \
            open(prefix + ".rebuilt.idx", "rb") as b:
        out["idx_byte_for_byte"] = a.read() == b.read()
    shards = os.path.join(tmp, "shards", "train")
    t0 = time.perf_counter()
    manifest = rec_shard.split(prefix + ".rec", c["shards"], shards)
    out["split_s"] = time.perf_counter() - t0
    out["shard_records"] = [s["records"] for s in manifest["shards"]]
    out["balanced"] = (max(out["shard_records"]) - min(out["shard_records"])
                       <= 1 and sum(out["shard_records"]) == c["images"])
    lst = {}
    with open(prefix + ".lst") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            lst[int(parts[0])] = (float(parts[1]), parts[-1])
    dataset = RecordDataset(shards + "-manifest.json")
    out["dataset_records"] = len(dataset)
    mismatched = 0
    labels_ok = True
    for i in range(len(dataset)):
        header, img = recordio.unpack_img(dataset.read(i))
        label, rel = lst[int(header.id)]
        labels_ok &= header.label == label
        mismatched += not np.array_equal(img, images[rel])
    out["decoded_mismatches"] = mismatched
    out["labels_match_list"] = bool(labels_ok)
    step = train_imagenet.build_train_step(c["network"], c["outputs"], None,
                                           mx.gpu(0))
    dev = mx.gpu(0).torch_device
    mean = torch.tensor(PIPE_MEAN, device=dev).view(1, 3, 1, 1)
    std = torch.tensor(PIPE_STD, device=dev).view(1, 3, 1, 1)

    def batch(k):
        rows = [recordio.unpack_img(dataset.read(k * c["batch"] + j))
                for j in range(c["batch"])]
        x = torch.from_numpy(np.stack([img[:, :, ::-1] for _, img in rows])
                             .transpose(0, 3, 1, 2).copy()).to(dev)
        y = torch.tensor([float(h.label) for h, _ in rows], device=dev)
        return (x.float() - mean) / std, y

    float(step(*batch(0)))                      # build
    torch.cuda.synchronize()
    losses = []
    t0 = time.perf_counter()
    for k in range(c["steps"]):
        losses.append(float(step(*batch(k))))
    out["feed_img_s"] = c["steps"] * c["batch"] / (time.perf_counter() - t0)
    out["losses"] = losses
    return out


def phase_toolkit(card_line, kernel_ms):
    """Phase 27 (see the module docstring). `kernel_ms`: phase 3's fp32
    K1/K2/K3 device ms at (8, 16, 2048, 64), causal. Returns its launch
    counts by path."""
    import os
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx

    t_phase = time.perf_counter()
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    read = {"phase": "toolkit", "card": card_line}
    reads = {}

    def reading(name, value):
        read[name] = value
        log(json.dumps({"phase": "toolkit", "reading": name,
                        "card": card_line, name: value}, default=str))

    tmp = tempfile.mkdtemp(prefix="toolkit-", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "mxnet_tpu_torch",
        "_build"))
    try:
        for name, path, part in (
                ("svrg", "toolkit_svrg", lambda: _toolkit_svrg(mx)),
                ("text", "toolkit_text", lambda: _toolkit_text(mx, tmp)),
                ("oracles", "test_utils_oracles",
                 lambda: _toolkit_oracles(mx, card_line, kernel_ms)),
                ("monitor_viz", "toolkit_monitor_viz",
                 lambda: _toolkit_monitor_viz(mx, tmp)),
                ("file_tools", "toolkit_file_tools",
                 lambda: _toolkit_file_tools(mx, tmp))):
            _reset_all_launches()   # this part's path starts here
            t0 = time.perf_counter()
            value = part()
            reads[path] = _all_launches()   # read just after it
            value["seconds"] = time.perf_counter() - t0
            reading(name, value)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    read["launches"] = reads
    read["seconds"] = time.perf_counter() - t_phase
    log(json.dumps({"phase": "toolkit", "card": card_line,
                    "launches": reads, "seconds": read["seconds"]},
                   default=str))

    sv = read["svrg"]
    check(sv["full_vs_batch_mean_rel_l2"] <= SVRG_FULL_REL_L2,
          "svrg: full gradient against the batch mean at relative L2 %g"
          % sv["full_vs_batch_mean_rel_l2"])
    check(sv["first_vs_full_rel_l2"] <= SVRG_FIRST_REL_L2,
          "svrg: first update after the snapshot at relative L2 %g from "
          "the full gradient" % sv["first_vs_full_rel_l2"])
    check(sv["corrected_vs_host_f64_rel_l2"] <= SVRG_CORRECTED_REL_L2,
          "svrg: corrected gradient against the host's float64 at %g"
          % sv["corrected_vs_host_f64_rel_l2"])
    check(sv["mse_by_epoch"][-1] < sv["mse_by_epoch"][0]
          and all(math.isfinite(v) for v in sv["mse_by_epoch"]),
          "svrg: MSE by epoch %s" % sv["mse_by_epoch"])
    check(sv["full_on_card"] and sv["grads_on_card"],
          "svrg: a gradient buffer left the card")
    tx = read["text"]
    check(all(tx["checks"].values()), "text: %s" % tx["checks"])
    ng = read["oracles"]["numeric_gradient"]
    check(ng["card_vs_host_f64_rel_l2"] <= ORACLE_GRAD_REL_L2,
          "oracles: the card's attention gradients at relative L2 %g from "
          "the host's float64" % ng["card_vs_host_f64_rel_l2"])
    sp = read["oracles"]["speed"]
    check(sp["whole_ms"] >= sp["kernels_device_ms_sum"],
          "check_speed whole %.3f ms below K1+K2+K3's device %.3f ms"
          % (sp["whole_ms"], sp["kernels_device_ms_sum"]))
    check(sp["forward_ms"] > 0, "check_speed forward %s" % sp)
    mv = read["monitor_viz"]
    check(mv["every_output_every_batch"],
          "monitor: reported %s" % mv["reported"])
    check(mv["stat_worst_rel"] <= MONITOR_STAT_RTOL,
          "monitor: a statistic at %g relative from mean(|x|) of the "
          "host copy" % mv["stat_worst_rel"])
    check(mv["summary_total_params"] == mv["module_params"] > 0,
          "print_summary counts %d parameters, the module holds %d"
          % (mv["summary_total_params"], mv["module_params"]))
    check(mv["dot_names_every_node"], "plot_network misses %s"
          % mv["dot_missing_nodes"])
    ft = read["file_tools"]
    check(ft["idx_byte_for_byte"], "rec2idx's .idx differs from im2rec's")
    check(ft["balanced"] and ft["dataset_records"] == FILE_TOOLS["images"],
          "rec_shard: shards %s" % ft["shard_records"])
    check(ft["decoded_mismatches"] == 0 and ft["labels_match_list"],
          "file tools: %d decoded images differ from their PNGs"
          % ft["decoded_mismatches"])
    check(all(math.isfinite(v) for v in ft["losses"]),
          "file tools: losses %s" % ft["losses"])
    for path, launches in reads.items():
        k = launches["k1_k2_k3"]
        if path == "test_utils_oracles":
            check(all(n >= 1 for n in k), "oracles launched K1-K3 %s"
                  % (k,))
        else:
            check(k == (0, 0, 0), "%s launched K1-K3 %s" % (path, k))
        check(launches["rtc"] == launches["bn_relu"] == 0
              and launches["scale_add"] == launches["relu"] == 0
              and not any(launches["d1_d2"]),
              "toolkit: launches on %s: %s" % (path, launches))
    log("phase 27: SVRG %.0f batches/s (Module %.0f), full pass %.2f s; "
        "text load %.1f s (300d); check_speed whole %.2f ms (K1-K3 device "
        "%.2f ms); monitor step %.1f ms (plain %.1f); pack %.0f img/s, "
        "feed %.1f img/s; oracle launches %s"
        % (sv["svrg_batches_s"], sv["module_batches_s"],
           sv["full_gradient_pass_s"], tx["load_s_300d"], sp["whole_ms"],
           sp["kernels_device_ms_sum"], mv["step_ms_monitor"],
           mv["step_ms_plain"], ft["pack_images_s"], ft["feed_img_s"],
           reads["test_utils_oracles"]["k1_k2_k3"]))
    return reads


# -- slice 24: the tools -------------------------------------------------------

# The four benches at their tools' defaults, except decode_bench: 64
# 224x224 PNG records (``--img-fmt .png --resize 0``, which the port's
# codec serves without cv2) at 0, 2 and 4 decode threads, 32 a batch, 6
# batches a count. The dist_sync group: one scheduler and one server,
# this process its worker, at the tool's three sizes, its arrays on the
# card, then on the host.
TOOLS = {"dispatch": {"iters": 200, "size": 256},
         "quantized": {"batch": 32, "channels": 256, "iters": 20},
         "decode": {"n": 64, "size": 224, "batch": 32, "batches": 6,
                    "threads": (0, 2, 4)},
         "kv_sizes": (262144, 1048576, 4194304), "kv_repeat": 5,
         "dist_servers": 1}


def _tools_dispatch(mx):
    """dispatch_bench's two rows on gpu(0); the eager and CachedOp
    chains' sums."""
    from mxnet_tpu_torch.tools import dispatch_bench

    cfg = TOOLS["dispatch"]
    text = _tool_text(dispatch_bench, ["--iters", str(cfg["iters"]),
                                       "--size", str(cfg["size"])])
    rows = [json.loads(r) for r in text.splitlines() if r.startswith("{")]
    with mx.gpu(0):
        (_, _, eager), (_, _, cached) = dispatch_bench.run(
            iters=2, size=cfg["size"])
    return {"rows": rows,
            "sums_on": [str(eager.context), str(cached.context)],
            "sums_bit_for_bit": eager.asnumpy().tobytes()
            == cached.asnumpy().tobytes(),
            "eager_sum": float(eager.asnumpy())}


def _tools_quantized(mx):
    """quantized_bench's two rows on gpu(0); the card's int8 conv and
    FC at the tool's shapes against the same operators on the host."""
    from mxnet_tpu_torch.ops import quantization_ops
    from mxnet_tpu_torch.tools import quantized_bench as qb

    cfg = TOOLS["quantized"]
    gemms = quantization_ops.INT8_GEMMS
    text = _tool_text(qb, ["--batch", str(cfg["batch"]),
                           "--channels", str(cfg["channels"]),
                           "--iters", str(cfg["iters"])])
    rows = [json.loads(r) for r in text.splitlines() if r.startswith("{")]
    gemms = quantization_ops.INT8_GEMMS - gemms
    data = qb.layers(cfg["batch"], cfg["channels"])
    parity = {}
    for key, (_, i8) in (("conv", qb.conv_fns(cfg["channels"])),
                         ("fc", qb.fc_fns())):
        x, _, wq = data[key]
        host = i8(torch.from_numpy(x), torch.from_numpy(wq))
        card = i8(torch.from_numpy(x).cuda(), torch.from_numpy(wq).cuda())
        err = float((card.cpu() - host).abs().max())
        # Both sides accumulate int8 x int8 exactly in int32; they differ
        # only by the float32 rescale: the int32 sum rounded to float32,
        # then times the float32 reciprocal of the scales, two roundings
        # of at most half an ulp of the largest output each.
        limit = 2 * 2.0 ** -24 * float(host.abs().max())
        parity[key] = {"max_abs_err": err, "limit": limit,
                       "shape": list(host.shape)}
    return {"rows": rows, "int8_gemms": gemms, "parity": parity}


def _tools_decode(mx, tmp):
    """decode_bench over PNG records on gpu(0) at TOOLS' thread counts;
    the JAX tool's JPEG workload where this host has cv2, else its
    refusal."""
    import os

    from mxnet_tpu_torch.tools import decode_bench

    cfg = TOOLS["decode"]
    rec, idx = decode_bench.make_dataset(tmp, cfg["n"], cfg["size"], ".png")
    seen, rates = [], {}
    for t in cfg["threads"]:
        rates[t] = decode_bench.bench(rec, idx, cfg["size"], cfg["batch"],
                                      cfg["batches"], t, resize=0,
                                      ctx=mx.gpu(0), seen=seen)
    out = {"png_img_s": rates, "batches": len(seen),
           "batch_contexts": sorted({str(c) for c in seen}),
           "host_cores": os.cpu_count()}
    try:
        import cv2  # noqa: F401
        has_cv2 = True
    except ImportError:
        has_cv2 = False
    out["host_has_cv2"] = has_cv2
    jpg = os.path.join(tmp, "jpeg")
    os.makedirs(jpg)
    if has_cv2:
        rec, idx = decode_bench.make_dataset(jpg, cfg["n"], cfg["size"])
        out["jpeg_resize_img_s"] = {
            t: decode_bench.bench(rec, idx, cfg["size"], cfg["batch"],
                                  cfg["batches"], t, ctx=mx.gpu(0))
            for t in cfg["threads"]}
    else:
        try:
            decode_bench.make_dataset(jpg, cfg["n"], cfg["size"])
            out["jpeg_refusal"] = None
        except ImportError as exc:
            out["jpeg_refusal"] = str(exc)
    return out


def _tools_bandwidth(mx):
    """bandwidth.measure: the device kvstore on the one card, then the
    dist_sync group's worker with its arrays on the card and on the
    host."""
    from mxnet_tpu_torch.tools.bandwidth import measure

    sizes, repeat = TOOLS["kv_sizes"], TOOLS["kv_repeat"]
    out = {}
    proof = []
    with mx.gpu(0):
        out["device"] = measure.measure("device", None, sizes, repeat,
                                        proof=proof)
    out["device_proof"] = sorted(set(proof))
    t0 = time.perf_counter()
    with measure.dist_group(TOOLS["dist_servers"]) as kv:
        out["dist_group_start_s"] = time.perf_counter() - t0
        for tag, ctx in (("dist_gpu", mx.gpu(0)), ("dist_cpu", mx.cpu())):
            proof = []
            out[tag] = measure.dist_rounds(kv, sizes, repeat, ctx=ctx,
                                           proof=proof, prefix=tag)
            out[tag + "_proof"] = sorted(set(proof))
    out["dist_seconds"] = time.perf_counter() - t0
    return out


def phase_tools(card_line):
    """Phase 28: the port's benches (see the module docstring). Returns
    their launch counts by path."""
    import os
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx

    t_phase = time.perf_counter()
    read = {}
    reads = {}
    tmp = tempfile.mkdtemp(prefix="tools-", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "mxnet_tpu_torch",
        "_build"))
    try:
        for name, part in (
                ("tools_dispatch", lambda: _tools_dispatch(mx)),
                ("tools_quantized", lambda: _tools_quantized(mx)),
                ("tools_decode", lambda: _tools_decode(mx, tmp)),
                ("tools_bandwidth", lambda: _tools_bandwidth(mx))):
            _reset_all_launches()   # this part's path starts here
            t0 = time.perf_counter()
            value = part()
            reads[name] = _all_launches()   # read just after it
            value["seconds"] = time.perf_counter() - t0
            read[name] = value
            log(json.dumps({"phase": "tools", "reading": name,
                            "card": card_line, name: value}, default=str))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log(json.dumps({"phase": "tools", "card": card_line, "launches": reads,
                    "seconds": seconds}, default=str))

    dp = read["tools_dispatch"]
    check([r["mode"] for r in dp["rows"]] == ["eager", "cached_op"]
          and all(r["value"] > 0 for r in dp["rows"]),
          "dispatch_bench rows %s" % dp["rows"])
    card_ctx = str(mx.gpu(0))
    check(dp["sums_on"] == [card_ctx] * 2 and dp["sums_bit_for_bit"],
          "dispatch_bench: eager and CachedOp sums %s" % dp)
    qt = read["tools_quantized"]
    check([r["metric"] for r in qt["rows"]] == [
        "conv3x3_int8_speedup", "fc2048x1000_int8_speedup"]
        and all(r["value"] > 0 and r["device"] == card_ctx
                for r in qt["rows"]), "quantized_bench rows %s" % qt["rows"])
    check(qt["int8_gemms"] > 0, "quantized_bench ran no int8 GEMM on the "
          "card")
    for key, row in qt["parity"].items():
        check(row["max_abs_err"] <= row["limit"], "int8 %s on the card "
              "against the host: %g > %g" % (key, row["max_abs_err"],
                                            row["limit"]))
    dc = read["tools_decode"]
    check(all(math.isfinite(r) and r > 0 for r in dc["png_img_s"].values())
          and dc["batch_contexts"] == [card_ctx],
          "decode_bench: %s" % dc)
    if not dc["host_has_cv2"]:
        check(dc["jpeg_refusal"] and "cv2" in dc["jpeg_refusal"],
              "JPEG records without cv2: %r" % dc["jpeg_refusal"])
    bw = read["tools_bandwidth"]
    hbm = PEAKS["H200" if "H200" in card_line else "H100"]["bytes"] / 1e9
    for tag in ("device", "dist_gpu", "dist_cpu"):
        check(len(bw[tag]) == len(TOOLS["kv_sizes"]) and all(
            math.isfinite(g) and g > 0 for _, _, g in bw[tag]),
            "bandwidth %s rows %s" % (tag, bw[tag]))
        check(bw[tag + "_proof"] == [1.0], "bandwidth %s pulled %s, pushed "
              "1.0" % (tag, bw[tag + "_proof"]))
    check(all(g < hbm for _, _, g in bw["device"]),
          "the device kvstore above HBM's %g GB/s: %s" % (hbm, bw["device"]))
    for path, launches in reads.items():
        check(launches["k1_k2_k3"] == (0, 0, 0)
              and launches["rtc"] == launches["bn_relu"] == 0
              and launches["scale_add"] == launches["relu"] == 0
              and not any(launches["d1_d2"]),
              "tools: launches on %s: %s" % (path, launches))
    log("phase 28: dispatch eager %.1f, cached_op %.1f us/op; int8 conv "
        "%.2fx, FC %.2fx; decode PNG img/s %s; kvstore GB/s device %s, "
        "dist card %s, dist host %s; %.1f s"
        % (dp["rows"][0]["us_per_op"], dp["rows"][1]["us_per_op"],
           qt["rows"][0]["value"], qt["rows"][1]["value"],
           {t: round(r, 1) for t, r in dc["png_img_s"].items()},
           [round(g, 2) for _, _, g in bw["device"]],
           [round(g, 3) for _, _, g in bw["dist_gpu"]],
           [round(g, 3) for _, _, g in bw["dist_cpu"]], seconds))
    return reads


_DIST_PARTS = {"nccl1": _dist_part_nccl1, "gloo2": _dist_part_gloo2,
               "kvstore": _dist_part_kvstore, "ssd": _dist_part_ssd,
               "place2": _place_part_tp2, "place4": _place_part_dp2tp2,
               "gateway_mesh": _gateway_part_mesh,
               "cc_ranks": _cc_part_ranks, "cc_warm": _cc_part_warm}


def _timed(phase, *args):
    """Run one phase of main() and log its seconds."""
    t0 = time.perf_counter()
    try:
        return phase(*args)
    finally:
        log(json.dumps({"phase_seconds": phase.__name__,
                        "seconds": round(time.perf_counter() - t0, 3)}))


def main():
    t_start = time.perf_counter()
    _reset_det_launches()   # phases 1-12's path starts here
    card_line = _timed(phase_device)
    card = torch.cuda.get_device_name(0)
    _timed(phase_build)
    fwd = _timed(phase_kernels, card)
    dkv, dq = _timed(phase_backward_kernels, card)
    served = _timed(phase_attention_served)
    _timed(phase_resnet_served)
    trained, trained32, attn_step_ms = _timed(phase_attention_trained)
    synthetic = _timed(phase_resnet_trained)
    direct, tensors = _timed(phase_rtc_direct)
    rtc_entries = _timed(phase_rtc_kernels, card, tensors)
    ckpt = _timed(phase_checkpoint_served)
    trainer = _timed(phase_resnet_trainer, card_line)
    attn_trainer, attn_trainer_ms = _timed(phase_attention_trainer,
                                           card_line)
    det_reads = {"phases_1_12": _det_launches()}   # read just after it
    pipeline = _timed(phase_input_pipeline, card_line, synthetic)
    ckpt_path = _timed(phase_checkpoint, card_line)
    module = _timed(phase_module, card_line, trainer["fp32"]["img_s_b32"])
    recurrent = _timed(phase_recurrent, card_line)
    core = _timed(phase_core_surface, card_line,
                  trainer["fp32"]["img_s_b32"])
    zoo = _timed(phase_model_zoo, card_line,
                 synthetic["fp32"]["img_s_b32"])
    _reset_det_launches()   # phase 19's path in this process starts here
    distributed = _timed(phase_distributed, card_line)
    det_reads["distributed"] = _det_launches()    # read just after it
    check(all(n == (0, 0, 0) for n in det_reads.values()),
          "D1/D2 launched before phase 20: %s" % det_reads)
    detection = _timed(phase_detection, card_line)
    placement = _timed(phase_placement, card_line)
    telemetry_reads = _timed(phase_telemetry, card_line)
    gateway_reads = _timed(phase_gateway, card_line)
    cc_reads = _timed(phase_compile_cache, card_line)
    sparse_reads = _timed(phase_sparse, card_line)
    quant_reads = _timed(phase_quantization_contrib, card_line)
    toolkit_reads = _timed(phase_toolkit, card_line, {
        "k1": fwd["fp32"]["device_ms"], "k2": dkv["fp32"]["device_ms"],
        "k3": dq["fp32"]["device_ms"]})
    tools_reads = _timed(phase_tools, card_line)
    for k, entry in enumerate(detection):
        for path, n in det_reads.items():
            entry["launches_by_path"][path] = n[k]
    rtc_entries["scale_add"]["launches"] = direct["scale_add"]
    rtc_entries["relu"]["launches"] = direct["relu"]
    rtc_entries["bn_relu"]["launches"] = \
        ckpt["partitioned"]["bn_relu_launches"]
    rtc_entries["bn_relu"]["launches_by_path"] = {
        "checkpoint_served_partitioned":
            ckpt["partitioned"]["bn_relu_launches"],
        "checkpoint_served_plain": ckpt["plain"]["bn_relu_launches"]}
    rtc_entries["k4"]["launches"] = direct["rtc"] + \
        ckpt["partitioned"]["rtc_launches"] + ckpt["plain"]["rtc_launches"]
    rtc_entries["k4"]["launches_by_path"] = {
        "rtc_direct": direct["rtc"],
        "checkpoint_served_partitioned": ckpt["partitioned"]["rtc_launches"],
        "checkpoint_served_plain": ckpt["plain"]["rtc_launches"]}
    fwd["launches"] = served + trained[0] + trained32[0] + attn_trainer[0]
    fwd["launches_by_path"] = {"attention_served": served,
                               "attention_trained": trained[0],
                               "attention_trained_fp32": trained32[0],
                               "resnet50_trained": 0,
                               "attention_trainer": attn_trainer[0],
                               "resnet50_trainer": 0}
    for entry, n, n32, m in ((dkv, trained[1], trained32[1], attn_trainer[1]),
                             (dq, trained[2], trained32[2], attn_trainer[2])):
        entry["launches"] = n + n32 + m
        entry["launches_by_path"] = {"attention_trained": n,
                                     "attention_trained_fp32": n32,
                                     "resnet50_trained": 0,
                                     "attention_trainer": m,
                                     "resnet50_trainer": 0}
    # Phase 19's dp TrainStep paths (the ranks' own counts: part 1's
    # one rank, part 2's two ranks summed, deterministic run included).
    for i, entry in enumerate((fwd, dkv, dq)):
        for path in ("nccl1", "gloo2"):
            n = distributed["k1_k2_k3_" + path][i]
            entry["launches_by_path"]["distributed_" + path] = n
            entry["launches"] += n
    rtc_list = [rtc_entries[k] for k in ("k4", "bn_relu", "scale_add",
                                         "relu")]
    # The input pipeline's (phase 13), the checkpoint's (14), the
    # Module's (15), the recurrent (16), the core surface's (17) and the
    # model zoo's (18) paths launch none of them.
    # The detection kernels (D1, D2 forward, D2 backward) are read there
    # too, and launch on phase 20's paths only. Phase 21's paths (each
    # summed over its ranks) launch K1-K3 on the tp2 attention path only,
    # phase 22's on its attention path only. Phase 23's gateway launches
    # K1 on its attention model (gateway_attention, gateway_shedding) and
    # K4a (and K4's rtc launch under it) on its checkpoint model
    # (gateway_checkpoint_partitioned). Phase 24's three children each
    # launch K1 once, K4a (and K4's rtc launch) 33 times and D1 once
    # (CC_LAUNCHES, every count read). Phase 25's sparse path launches
    # none of them. Phase 26's six paths launch K4a (and K4's rtc launch
    # under it) on the partitioned int8 server only, 33 times a forward.
    # Phase 27's test oracles (test_utils_oracles) launch K1, K2 and K3
    # in fp32; its other four paths launch none of them. Phase 28's four
    # paths (tools_dispatch, tools_quantized, tools_decode,
    # tools_bandwidth) launch none of them.
    for path, read in (("input_pipeline", pipeline["launches"]),
                       ("checkpoint", ckpt_path["launches"]),
                       ("module", module["launches"]),
                       ("recurrent", recurrent["launches"]),
                       ("core_surface", core["launches"]),
                       ("model_zoo", zoo["launches"]),
                       *placement.items(), *telemetry_reads.items(),
                       *gateway_reads.items(), *cc_reads.items(),
                       *sparse_reads.items(), *quant_reads.items(),
                       *toolkit_reads.items(), *tools_reads.items()):
        for entry, n in zip([fwd, dkv, dq] + rtc_list + detection,
                            list(read["k1_k2_k3"]) + [read["rtc"],
                                                      read["bn_relu"],
                                                      read["scale_add"],
                                                      read["relu"]]
                            + list(read["d1_d2"])):
            entry.setdefault("launches_by_path", {})[path] = n
            entry["launches"] += n
    for entry in [fwd, dkv, dq] + rtc_list:
        entry["card"] = card_line
    log(json.dumps({"kernels": [fwd, dkv, dq] + rtc_list + detection,
                    "attention_train_step_ms": attn_step_ms,
                    "attention_trainer_step_ms": attn_trainer_ms}))
    log("total_seconds", round(time.perf_counter() - t_start, 3))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    import faulthandler

    # A native abort (SIGABRT, SIGSEGV) prints every thread's Python
    # stack to stderr before the process dies.
    faulthandler.enable(all_threads=True)
    if "--dist-part" in sys.argv:
        # A rank of phase 19 (or a scheduler/server of its part 3, whose
        # loop runs inside this import and never returns).
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        _dist_role_record(args["--dist-dir"])
        import mxnet_tpu_torch  # noqa: F401

        kw = {"lr": float(args["--dist-lr"])} if "--dist-lr" in args else {}
        _DIST_PARTS[args["--dist-part"]](args["--dist-dir"], **kw)
        sys.exit(0)
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; it drives mxnet_tpu_torch on "
              "an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    sys.exit(main())
