#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mxnet_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (a non-zero exit) when it fails, in the
order they run:

(a) identity: the card's name and power limit, as nvidia-smi reports them;
(b) build: every CUDA source of the port (flash_attention.cu,
    row_kernels.cu), compiled in parallel from the sources in this checkout
    with nvcc for sm_90a (timed), with ptxas' register and spill lines;
(c) flash kernel vs plain version on the card, for its out and lse, each
    case on the body the wrapper must pick (printed, and held to the body's
    launch count): the served shape, contiguous and as the strided views of
    the fused qkv that the model passes, causal and not (the wgmma body),
    and with K/V broadcast over heads or batch by a zero stride (the
    mma.sync body at D = 128); small f32 shapes, decode shapes
    (Tq < Tk: Tq = 1, 16, 77), a ragged T = 1006, B*H = 1, Tq = Tk = 1000,
    head dims 16/40/64/256, f16 at a small and the served shape, the empty
    cases, the two ValueError cases, and the autograd gradient;
(g) row kernels vs plain versions on the card (layernorm, rmsnorm, softmax,
    softmax_xent): f32, bf16 and f16 at the model's shapes, a ragged
    N = 1006, widths 32, 50 and 1000, N = 0, an input at an odd offset,
    labels -1 and V, gamma/beta in another dtype than x, rows with a large
    mean; the two bodies of LayerNorm, RMSNorm and softmax at 8 x 1024 rows
    (LayerNorm's warp body and the ring body of the other two at widths
    1024, 2048 and 1000 in bf16 and 1024 in f32; the block body at widths 50
    and 4096 and at an odd offset), each on the body the wrapper must pick;
    edge rows on both bodies of softmax (one layer's causal scores with the
    upper triangle -inf, a row all -inf, a NaN row) and RMSNorm (a zero row,
    a row all -inf, a NaN row), NaN at the same places as the plain version
    and a -inf score exactly 0; the dtype errors; each autograd Function's
    gradient;
(d) serving: the bench transformer at full width (D=1024, 8 layers,
    8 heads x 128, S=1024, V=16384, bf16, weights from seed 0) behind
    ServingEngine.from_forward(max_batch=8) answers requests of 8, 5 and
    11 rows.
    Their logits are held against a reference forward built on the plain
    attention, and the kernel's launch count, all on the wgmma body, must be
    8 layers x chunks;
(h) the NDArray path at full width, through mxnet_tpu_torch.nd on gpu(0):
    nd.LayerNorm on [8, 1024, 1024] bf16 (on the warp body), nd.softmax on
    one layer's attention scores [8, 8, 1024, 1024] bf16 and
    ops.fused_rmsnorm on [8, 1024, 1024] bf16 (both on the ring body), and
    bench's training loss:
    the full-width model on bench's 8 x 1024 tokens, its logits cast to f32,
    through nd.softmax_cross_entropy / N against bench's labels. Each is
    held to its plain version, and each kernel's launch count must grow by
    its calls;
(i) mx.rtc on the card (K7): NVRTC's library and version; user kernels
    written in CUDA C and compiled at run time through
    mxnet_tpu_torch.rtc.Rtc(mode='cuda') for sm_90a: k7a the reference's
    mx.rtc test kernel, k7b the JAX test's triple, k7c bench's rms on the
    full-width activations [8, 1024, 1024] bf16 and k7d the tanh GELU on the
    MLP's hidden activations [8, 1024, 4096] bf16. A first compile and a
    cached one (a second Rtc of the same source must not compile), a body
    with a syntax error (MXNetError with NVRTC's log), a 2048-thread block
    and CPU tensors (ValueError, no launch). The main path: an imperative
    step on gpu(0) through the nd surface (x[:] = ..., the pushes, x * 0.5,
    x + y, a slice, .sum()) on layer 0's MLP input, with each user kernel's
    launch count; the step is held to torch on the same tensors and to the
    plain chain, and each user kernel to its plain version;
(j) bench's training step at full width (make_train_step: bf16 copies of
    the f32 masters through the model on the flash kernel, the loss
    mean(logsumexp - gold) on f32 logits, one mp_sgd_mom_update per master)
    for five steps from seed 0, and the same steps on the plain attention:
    the first three steps' losses and the masters after step 1 held to the
    plain attention's, the loss falling from step 1 to step 5 (bench's step
    raises it for two steps first), and the kernel's launches growing by 8
    (one a layer, on the wgmma body) each step; the loss along the first
    step's gradient at three step sizes; then
    one update through optimizer.create('sgd', momentum=0.9,
    learning_rate=0.01, multi_precision=True) and get_updater on NDArrays of
    the bf16 weights, held bit for bit to the registry op's on the same
    gradients;
(k) bench's default ResNet-50 step and the graph path on the card:
    (k1) bench.py:291-370 composed from the port's public parts
    (graph_train.make_train_step: vision.get_model('resnet50_v1'),
    hybridize, _get_graph with a placeholder of (32, 3, 224, 224),
    _GraphProgram, infer_shape, make_runner; f32 masters from bench's
    _host_init on RandomState(0); BN aux cast to bf16 into the graph and
    stored back as f32; mean(logsumexp - gold) on f32 logits; one
    mp_sgd_mom_update per master) for five steps, finite and with the loss
    falling; step 1's loss, gradients and new BN statistics against the
    same step in f32 compute, and its gradients with the graph in
    prediction against f32's; the same net through Gluon in f32, its
    hybridized logits against its imperative ones and the imperative
    forward's autograd gradients against the runner's; (k2) a Symbol
    LayerNorm -> FullyConnected -> f32 -> softmax_cross_entropy at bench's
    transformer widths simple_bind'ed on gpu(0), forward and backward held
    to the plain versions, with K4's and K3's launches; (k3) nd.LayerNorm,
    nd.softmax and nd.softmax_cross_entropy at the model's shapes under
    autograd.record(), backward held to the plain versions, with K3-K5's
    launches (the kernel record's executor_launches and
    autograd_launches; K6's are counted in both runs and held at 0);
(e) times from CUDA events: the flash kernel (wgmma body), its plain
    version and PyTorch's scaled_dot_product_attention at the served shape
    and at [1, 16384, 8, 128], the kernel's bound, the host time of one
    call, the full-width forward's tokens/s, and each request's latency;
    each row kernel (LayerNorm on its warp body, softmax and RMSNorm on the
    ring body), its plain version and one PyTorch call at the shapes of (h),
    with their bounds; for softmax and RMSNorm also the block and the ring
    body in turns (block, ring, ring, block) through the C entry, a copy of
    the same x, and the ring body and library call with a clean L2; each
    user kernel
    of (i), its plain version and one PyTorch call where there is one, with
    their bounds; the training step of (j) (step ms and tokens/s, on the
    kernel and on the plain attention), its forward, backward and update,
    and one layer's plain-attention recompute in the backward;
(f) where the forward's device time goes (torch.profiler);
(k) the ResNet-50 step's times: step ms and images/s (CUDA events, median
    of 5 after a warm-up) and the host's wall time, the split into forward
    and loss, backward and update, and torch.profiler's top device kernels
    and idle share over 3 steps;
(l) Module.fit, the kernels through Module and the Gluon loop (run after
    (k), before (m)); (l1) and (l2) run with MXTPU_FUSED_FIT=0 and
    MXTPU_FUSED_EVAL=0, the per-batch loops, and restore the flags after:
    (l1) train_imagenet's recipe on bench's model at full
    width: mxnet_tpu_torch.mod.Module(resnet50_v1 hybridized and traced by
    _get_graph, under SoftmaxOutput) on the default context (the card),
    bound and initialised by Xavier(gaussian, in, 2), then fit for one
    epoch over NDArrayIter(256 f32 images 3 x 224 x 224 and int labels from
    RandomState(0), batch 32) with sgd (lr 0.1, momentum 0.9, wd 1e-4),
    eval_metric ['acc'], kvstore 'device' and Speedometer(32, 4): every
    bound array on the card, batch 1's loss (from get_outputs) and update
    against graph_train's f32 step from the same masters, aux states and
    batch, the acc metric's hits against the outputs' on every batch, the
    outputs finite (a batch's loss -log(p) is inf where a probability
    underflows to 0, NaN never), a fit batch's CUDA-event and host wall ms and
    Speedometer's samples/s, then save_checkpoint, Module.load into a fresh
    module and predict on one batch, bit for bit; (l2) (k2)'s head under
    MakeLoss (f32 x [8192, 1024], V = 16384, label_names ('label',),
    eval_metric 'loss') through Module.fit for one epoch of 3 batches and
    Module.score, K4's and K3's launches counted in each (3 and 3; K5 and
    K6 0; the kernel record's module_launches) and each batch's loss held
    to the plain versions; (l3) the same ResNet-50 imperative under
    autograd.record() with gluon.loss.SoftmaxCrossEntropyLoss, backward
    and gluon.Trainer(sgd).step(32) for two steps, step 1's loss and update
    against (l1)'s f32 step and every parameter still on the card;
(m) the fused W-step windows (W = 4) of Module.fit, score and predict,
    the defaults (run after (l), before (e)): (m1) (l1)'s set-up over 10
    batches of 32 from RandomState(0), with eval_metric ['acc', 'ce'] (the
    ce statistic gives each batch's loss, which the window keeps on the
    card) through the windowed Module.fit: two windows and a tail of two
    per-batch steps, one host fetch a window, no synchronising call inside
    a window (torch's sync debug mode), the batch_end_callback's (epoch,
    nbatch) 0-9 in order, the 10 losses finite, the masters after window 1
    against 4 steps of the per-batch loop from the same masters, aux states
    and momentum (run twice for the floor), score(['acc', 'ce']) and
    predict over 8 batches with and without the window, and a window
    batch's CUDA-event and host wall ms, images/s and Speedometer's
    samples/s beside (l1)'s per-batch figures; (m2) (l2)'s head through
    the windowed Module.fit (one window of 4 batches, 'loss' in host-metric
    mode) and Module.score (one window), K4's and K3's launches counted in
    each (4 and 4; K5 and K6 0; the kernel record's window_launches), each
    batch's loss against the plain versions (fit: their trajectory from the
    same parameters under the same update op; score: on the trained
    parameters);
(n) the serving plane, with the port's telemetry on (run after (m), before
    (e)): (n1) (l1)'s checkpoint of the fitted ResNet-50 through
    ServingEngine.from_checkpoint on the card (max_batch 32, buckets 1-32
    warm), DynamicBatcher and the HTTP server on a loopback port, then the
    same for the logits of its checkpoint before the fit (the fitted net,
    and the initial one's probabilities, answer every image alike): a lone
    .npy request of 32 images (a full bucket) bit for bit against
    Module.predict at batch 32 under cuDNN's deterministic algorithms, then
    8 client threads of 4 .npy requests of 1-8 images and one JSON request
    of 1 image, each answer against Module.predict, the X-Request-Id echoed,
    no serve.build span after warmup, /healthz 200 and the latency
    quantiles on /metrics; it prints the request latency p50/p99 (client
    host clock), the server's histograms, queue wait p50, pad fraction,
    dispatches, rows a dispatch and images/s; (n2) (d)'s decoder through
    ServingEngine.from_forward (max_batch 8) behind DynamicBatcher: 12
    requests of 1-3 rows from 4 threads, 8 flash launches a dispatch on the
    wgmma body and the logits held as (d) holds them; (n3) the decoder's
    head softmax(FullyConnected(LayerNorm(x), 16384, no bias)) at D = 1024
    as a Module checkpoint through from_checkpoint (max_batch 64) and the
    batcher: 12 requests of 1-40 rows from 4 threads, one launch each of
    LayerNorm's and softmax's kernels a dispatch (the kernel record's
    serving_launches), the probabilities within 1e-5 of the plain versions;
(o) the rest of the op library and the model-zoo families (run after (n),
    before (e)): (o1) bench's alexnet step (graph_train.make_train_step(
    'alexnet', 256, 224, 1000), lr 0.01) and (o2) its inceptionv3 step (32 x
    3 x 299 x 299, lr 0.1), each for five steps, finite and with the loss
    falling from step 1 to step 2, step 1 against the same step in f32 with
    the same Dropout masks, the step's CUDA-event and host wall ms,
    images/s, and torch.profiler's kernels a step and idle share; (o3)
    vgg16_bn, densenet121 and squeezenet1.1 hybridized against imperative
    at batch 8 x 224 in f32; (o4) the decoder head through the new names,
    nd.LayerNorm (K4) -> nd.dot with W [1024, 16384] -> nd.softmax (K5) ->
    nd.topk(k=5, ret_typ='both') on x [8192, 1024] bf16 (one K4 and one K5
    launch; probabilities within 1e-5 of the plain versions, the dot on 64
    rows against float64, topk against a host sort), batch_dot at [64,
    1024, 128] x its transpose in bf16, sort/argsort/topk on rows with ties
    and NaN against the CPU (exact), the linalg_* family on 64 f32 matrices
    of 128 x 128 against float64 (gelqf by L Q = A, Q Q^T = I and L lower
    triangular), the regression heads' and SVMOutput's gradients under
    autograd.record() against the CPU; (o5) softmax_cross_entropy at [8192,
    16384] f32 with a (1,) label through the softmax_xent kernel (counted,
    against the plain version with the label broadcast) and a (3,) label
    raising ValueError before any launch (the kernel record's
    op_library_launches);
(p) the training loop's telemetry and the profiler (run after (o), before
    (e)): (p1) (l1)'s recipe over 8 batches, through the per-batch loop
    (MXTPU_FUSED_FIT=0) and the fused window (W = 4), each run four times
    from the same masters under cuDNN's deterministic algorithms: telemetry
    off, on (MXTPU_TELEMETRY=1, MXTPU_TIMELINE=1; the window's with
    MXTPU_XPROF=4:8), on, off. Every run's final parameters and aux states
    bit for bit the first's; each loop's leaf spans in its JSONL log,
    fit.steps 8 (the window's fused_fit.windows 2 and steps_per_call 4),
    the Speedometer's gauge; the goodput record's buckets and overhead
    summing to its wall within 5 ms, its step bucket above 0; the timeline
    record's draw, put, dispatch and fetch ms a step; the XPROF trace's
    kernel events; a batch's host ms with telemetry on and off, printed,
    not held. (p2) (l2)'s head through the per-batch Module.fit and
    Module.score inside mx.profiler.Profiler(mode='all'): the fit.*,
    eval.*, exec_group.* and executor.* spans in profile.json, the device
    trace in profile_cuda/ naming layernorm_rows_kernel (K4's warp body)
    and xent_kernel (K3) as often as their launch counters grew (the kernel
    record's profiler_launches), each batch's loss held as (l2) holds it,
    and K3's and K4's device ms a launch from the trace, printed beside
    (e)'s event timings;
(q) the data plane (run after (p), before (e)): (q0) a .rec and .idx of
    320 images of 3 x 256 x 256 uint8 ('.raw': this machine has no Pillow)
    from RandomState(0), labels in [0, 1000), written by the port's
    MXIndexedRecordIO on the native writer (built with g++ from
    src/recordio.cc; the check fails if it did not load), read back byte
    for byte by the native and the Python readers, in order and by key,
    with the write, read and scan MB/s; (q1) train_imagenet's --data-train
    recipe, (l1)'s Module on it: ImageRecordIter(data_shape (3, 224, 224),
    batch 32, shuffle, rand_crop, rand_mirror, the means of MXNet's
    common/data.py, std 1, preprocess_threads 4), one epoch of 10 batches
    from the same masters after random.seed(7), under cuDNN's
    deterministic algorithms, three ways: the per-batch loop on the host
    augment, the window on the host augment, the window on the deferred
    device augment (device_augment=1); batch 1 of run 1 (outputs and the
    parameters after its update) bit for bit against the same decoded
    batch through NDArrayIter from the same masters, run 3's masters after
    window 1 bit for bit against 4 per-batch steps on the eager device
    augment, no synchronising call inside a window, every loss finite,
    one batch of the device augment (cropping on the card, and after the
    host crop) within 1e-6 relative of the host augment with the
    randomness off; each run's images/s, a batch's CUDA-event and host
    wall ms, goodput's input_wait share, the timeline's draw and put ms a
    step and the bytes uploaded a batch, beside (l1)/(m1)'s NDArrayIter
    figures; (q2) MNISTIter over idx files written from synthetic_mnist
    into an MLP through Module.fit (accuracy above 0.5 after one epoch),
    and gluon.data.vision.MNIST(root) through transform_first, the
    DataLoader (batch 128, shuffle) and split_and_load into a Gluon MLP
    under autograd.record() with the loss and Trainer (the loss falling);
    (q3) (l2)'s head inputs (x [3 x 8192, 1024] f32 and labels from
    RandomState(22)) through ArrayDataset, DataLoader(batch_size=8192) and
    split_and_load into nd.LayerNorm (K4) -> nd.FullyConnected to 16384
    -> Cast f32 -> nd.softmax_cross_entropy (K3) under autograd.record(),
    backward and gluon.Trainer(sgd).step: K4's and K3's launches 3 and 3
    (K5 and K6 0; the kernel record's data_plane_launches), each batch's
    loss against the plain versions on the parameters it ran with;
(r) the RNN stack (run after (q), before (e); TF32 stays off, so cuDNN's
    LSTM runs in f32): (r1) lstm_bucketing at MXNet's example widths and
    Penn Treebank's vocabulary (10,000 words, embed 200, two LSTMCells of
    200 in a SequentialRNNCell, batch 32, buckets 10-60, sgd lr 0.01, wd
    1e-5, Xavier(in, 2.34)) through mx.mod.BucketingModule.fit on
    BucketSentenceIter over seeded Zipf sentences, two passes of two
    batches a bucket: the first batch's softmax outputs and gradients
    against the same module on the CPU, the perplexity falling, no fused
    window built, a batch's synced host wall ms by bucket; (r2) the same
    model on mx.rnn.FusedRNNCell (the RNN op on cuDNN): its outputs against
    unfuse()'s cells on (r1)'s weights, the op's fused body against
    _rnn_plain (outputs, final states, gradients) at T 60, and its ms a
    batch beside (r1)'s; (r3) Gluon's word language model (Embedding ->
    gluon.rnn.LSTM(200, 2 layers, dropout 0.2) -> a tied Dense, bptt 35,
    the hidden state carried and detached, clip_global_norm,
    Trainer('sgd')) for 8 steps with the loss falling, and the held-out
    loss through nd.softmax_cross_entropy (K3, one launch) against the sum
    of SoftmaxCrossEntropyLoss, K3's per-row losses at that [1120, 10000]
    against the plain -log_softmax pick row by row; (r4) serving.DecodeEngine over (r1)'s
    trained model's step (Embedding -> two LSTMCell steps, their four
    states as data inputs -> FullyConnected(10000) -> softmax, K5 on its
    block body, one launch a dispatch): 20 sessions over 16 slots, 16
    tokens each, with LRU evictions and re-admissions, every token's
    probabilities against a per-step reference (a batch-1 Module on the
    CPU fed its states), the ms a token by bucket, and K5 at [16, 10000]
    f32 held against its plain version and timed beside it, torch.softmax
    and its bound; (r5)
    examples/ctc/lstm_ocr.py's recipe through gluon.loss.CTCLoss(layout=
    'TNC') for 8 batches with the loss falling, the CTC loss and its
    gradient on the card against the CPU. K3's and K5's launches there are
    the kernel record's rnn_launches;
(s) the staged executor path (run after (r), before (e); every kernel's
    launches counted over (s2), the kernel record's staged_launches, and
    over (s3)'s fit, its custom_launches): (s1) (l1)'s recipe over 4
    batches through Module.fit with Monitor(2, pattern='.*') and without
    one (the per-batch loop, cuDNN's deterministic algorithms): the final
    parameters and aux states bit for bit, each monitored batch's rows one
    per op output and argument with every RMS finite, a monitored and a
    plain batch's host ms; (s5) one of its ResNet-50 convolution weights
    set to NaN: first_nonfinite_node names it and Monitor.nan_watch's rows
    flag it; (s2) the decoder head x [8192, 1024] f32 -> LayerNorm (K4) ->
    FullyConnected to 16384 -> softmax (K5), softmax_cross_entropy (K3)
    beside it, simple_bind'ed on gpu(0) with a monitor installed: one
    launch each, the monitor's rows, outputs and gradients bit for bit the
    same executor's without it, partial_forward stepped to 0 left bit for
    bit forward, the probabilities (1e-5) and loss against the plain
    versions; (s3) examples/numpy-ops/custom_softmax.py's op with its
    forward over nd.softmax (K5) in the softmax's place: its gradients
    against SoftmaxOutput(normalization='null')'s (relative RMS 1e-5),
    Module.fit over 3 batches of 8192 (one K4 and one K5 launch a batch, no
    fused window), a NumpyOp and an NDArrayOp at [16, 32]; (s4)
    examples/rnn/model_parallel_lstm.py's symbol at lstm_bucketing's widths
    (V 10,000, embed 200, hidden 200, batch 32, T 35, 4 layers) bound with
    layer 0 on cpu(0) and layers 1-3 on the card, against the same graph on
    the card alone (outputs 1e-5, gradients 1e-4 relative RMS), every op's
    output on its group's device, the loss falling over 4 SGD steps; (s6)
    the native engine (src/engine.cc built by g++): writers in order with
    their readers between them, wait_for_all after queued matmuls leaving
    the card idle, the engine's op spans in a profiler dump; (s7)
    print_summary of resnet50_v1 at 224 and its total.
(t) sparse storage and the contrib detection and vision ops (run after
    (s), before (e); the kernel record's sparse_launches count (t3)'s
    launches, its contrib_launches those of (t4)-(t6)); each sub-phase
    holds the card against the port on the CPU for the same inputs (f32
    values within 1e-5 of the largest |CPU| value, gradients 1e-4, integer
    results, class ids and codes exactly): (t1)
    examples/sparse/linear_classification.py's recipe at Avazu's width
    (1,000,000 features, 10-30 a row, 32 batches of 256 from a generated
    libsvm file through LibSVMIter; two passes, the log loss falling),
    nd.sparse.dot against the dense lowering, and the reference script's
    Module form (sym.sparse.dot of a csr Variable with a row_sparse
    weight, kv.row_sparse_pull before each batch, the batch densified on
    the card); (t2) csr [8192, 1,000,000] -> dense -> csr and row_sparse
    [1,000,000, 128] -> dense -> row_sparse, retain, add, square_sum and
    nd.save/nd.load bit for bit (the files byte for byte); (t3) a
    multi-class head W [1,000,000, 128] over (t1)'s batches through
    nd.softmax_cross_entropy (K3) and nd.softmax (K5), one launch each a
    batch, held against xent_ref and softmax_ref; (t4) train_ssd.py's
    recipe through Module.fit from its .rec, its MultiBoxDetection decode,
    then MultiBoxPrior, MultiBoxTarget, MultiBoxDetection and box_iou at
    SSD300's widths (8,732 anchors, 21 classes, batch 32, 1-16 objects);
    (t5) train_rcnn_lite.py's two stages, then MultiProposal at the op's
    defaults on [2, 18, 38, 63] and ROIPooling 7 x 7 over its 600 rois on
    [2, 512, 38, 63], forward and backward; (t6) quantize_mlp.py, bench's
    resnet50_v1 parameters to uint8 and back, DeformableConvolution on
    res5 (3 x 3, 512 -> 512, dilate 2), PSROIPooling and
    DeformablePSROIPooling (R-FCN's 21 x 7 x 7 over 600 rois),
    Correlation (FlowNetC's [4, 256, 48, 64], displacement 20, stride 2),
    SpatialTransformer, GridGenerator and BilinearSampler on [32, 3, 224,
    224], fft/ifft on [256, 4096], count_sketch to 8,192 over [4096, 512]
    and IdentityAttachKLSparseReg on [256, 1024] in training, each timed
    with CUDA events;
(u) the resilience tier (run after (t), before (e); the kernel record's
    resilience_launches count (u2)'s launches), under cuDNN's
    deterministic algorithms where it holds a run bit for bit: (u1)
    train_imagenet's recipe on ResNet-50 (as (l1), 12 batches) through
    resilient_fit with checkpoints every 4 steps, MXTPU_HEALTH=1 with
    action raise and nan-grad at batch 6, on the window (W = 4) and on the
    per-batch loop: one restart from step 4, the incident at step 6 with
    the bisect naming the input, the final parameters, aux states and
    momenta bit for bit the uninterrupted run's, no synchronising call
    inside a window; the size of a checkpoint, a batch's host ms with
    checkpoints and sentinels on and off, and the ckpt.save span printed;
    (u2) (l2)'s head (x [8192, 1024] f32 -> LayerNorm (K4) ->
    FullyConnected to 16,384 -> MakeLoss(softmax_cross_entropy) (K3))
    through the windowed Module.fit with health and dynamics on,
    checkpoints every 2 steps and dispatch-exception at step 5 under
    resilient_fit: one K3 and one K4 launch a trained step, each batch's
    loss against the plain versions' trajectory, the final state bit for
    bit the uninterrupted run's, window step 0's health row against its
    recomputation from that step's gradients (1e-5); (u3)
    checkpoint-corrupt on the head's step-8 checkpoint: the next fit falls
    back to step 4 and ends bit for bit on the uninterrupted run; (u4)
    python -m mxnet_tpu_torch.train_supervisor over a child that fits the
    head on the card, once with host-loss (exit 113) and once with hang
    under the watchdog's abort (exit 85, its abort hook certifying the save
    in flight), beside an uninterrupted child: each relaunch resumes from
    the certified pointer and saves the uninterrupted child's state bit
    for bit.

The second-to-last line of its output is the kernel record
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
Without CUDA, or without the package beside it, it exits non-zero and
prints neither.
"""
import json
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, the dense bf16
# tensor-core FLOP/s and the f32 FLOP/s outside the tensor cores. The bound
# of a kernel is the larger of its bytes over the memory rate and its
# operations over the peak for their type.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
SOURCES = ('flash_attention', 'row_kernels')

SERVE_ROWS = (8, 5, 11)         # requests: full bucket, padded, chunked
MAX_BATCH = 8
TIMED_RUNS = 30


def log(*args):
    print(*args, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError('chip_smoke check failed: %s' % what)


# ---------------------------------------------------------------------------
# (a) identity
# ---------------------------------------------------------------------------

def card_identity():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


# ---------------------------------------------------------------------------
# (c) kernel vs plain version
# ---------------------------------------------------------------------------

# (label, B, Tq, Tk, H, D, dtype, causal, body): body is the one the
# wrapper must pick. bf16 at D = 128 with 16-byte aligned bases and
# positive 16-byte strides runs the wgmma body (TMA, mbarriers, wgmma);
# bf16 at D in {16, 32, 64}, and at D = 128 with K/V broadcast by a zero
# stride (which no TMA map takes), the mma.sync body; f32, f16 and other
# head dims the scalar body. The served layout's q, k, v are the strided
# views the model gives the kernel: [B, T, H, 3*D] split on the last axis
# (token stride 3*H*D, head stride 3*D, offsets 0, D and 2*D). The
# broadcast cases expand one K/V head over H heads (multi-query attention)
# or one K/V batch row over B.
SERVED_LAYOUT = 'served layout (qkv views)'
BROADCAST = {'K/V expanded over heads': 'heads',
             'K/V expanded over batch': 'batch'}
CASES = [
    ('served shape', 8, 1024, 1024, 8, 128, 'bfloat16', True, 'wgmma'),
    ('served shape', 8, 1024, 1024, 8, 128, 'bfloat16', False, 'wgmma'),
    (SERVED_LAYOUT, 8, 1024, 1024, 8, 128, 'bfloat16', True, 'wgmma'),
    (SERVED_LAYOUT, 8, 1024, 1024, 8, 128, 'bfloat16', False, 'wgmma'),
    ('K/V expanded over heads', 8, 1024, 1024, 8, 128, 'bfloat16', True, 'mma'),
    ('K/V expanded over batch', 2, 256, 256, 4, 128, 'bfloat16', False, 'mma'),
    ('f32 small', 2, 128, 128, 4, 64, 'float32', False, 'scalar'),
    ('f32 small causal', 2, 128, 128, 4, 64, 'float32', True, 'scalar'),
    ('decode Tq=1 Tk=32', 4, 1, 32, 8, 128, 'bfloat16', True, 'wgmma'),
    ('decode Tq=16 Tk=32', 4, 16, 32, 8, 128, 'bfloat16', True, 'wgmma'),
    ('decode Tq=1 Tk=1024', 4, 1, 1024, 8, 128, 'bfloat16', True, 'wgmma'),
    ('decode Tq=16 Tk=1024', 4, 16, 1024, 8, 128, 'bfloat16', True, 'wgmma'),
    ('decode Tq=77 Tk=1024', 4, 77, 1024, 8, 128, 'bfloat16', True, 'wgmma'),
    ('decode f32 Tq=16 Tk=1024', 2, 16, 1024, 4, 64, 'float32', True, 'scalar'),
    ('ragged T=1006', 1, 1006, 1006, 2, 128, 'bfloat16', True, 'wgmma'),
    ('ragged f32 T=1006', 1, 1006, 1006, 2, 64, 'float32', False, 'scalar'),
    ('B*H=1', 1, 1024, 1024, 1, 128, 'bfloat16', True, 'wgmma'),
    ('Tq=Tk=1000', 2, 1000, 1000, 4, 128, 'bfloat16', True, 'wgmma'),
    ('Tq=Tk=1000', 2, 1000, 1000, 4, 128, 'bfloat16', False, 'wgmma'),
    ('D=16', 2, 256, 256, 4, 16, 'bfloat16', True, 'mma'),
    ('D=16 f32', 2, 256, 256, 4, 16, 'float32', True, 'scalar'),
    ('D=64', 2, 256, 256, 4, 64, 'bfloat16', False, 'mma'),
    ('D=40 scalar body', 2, 200, 200, 2, 40, 'bfloat16', True, 'scalar'),
    ('D=256 scalar body', 1, 128, 128, 2, 256, 'bfloat16', True, 'scalar'),
    ('f16 small', 2, 128, 128, 4, 64, 'float16', False, 'scalar'),
    ('f16 served shape', 8, 1024, 1024, 8, 128, 'float16', True, 'scalar'),
]

# Tolerances (|kernel - plain| <= atol + rtol * |plain|), with their reasons:
# - f32: both sides compute in f32 with the sums in another order (and the
#   plain side's matmuls with TF32 off): a few f32 ulps of the row sums,
#   the tolerance the JAX package's own kernel tests use (2e-5).
# - bf16 out: the kernel rounds p to bf16 before the p.v product, and both
#   sides round the output to bf16 once (2**-8 relative each): 1e-2.
# - f16 out (the scalar body: p stays f32, and both sides round the f32
#   output to f16 once): one f16 ulp, rtol 2**-10; atol 1e-6 for f16's
#   subnormals.
# - lse (f32 on both sides, the scores exact products of bf16 inputs
#   summed in f32): 1e-4.
TOL = {'float32': (2e-5, 2e-5), 'bfloat16': (1e-2, 1e-2),
       'float16': (1e-6, 2 ** -10)}
LSE_TOL = (1e-4, 1e-4)


def qkv(B, Tq, Tk, H, D, dtype, device, seed=0, interleaved=False,
        broadcast=None):
    """q, k, v from ``seed``: contiguous, or (``interleaved``, Tq == Tk)
    views of one head-interleaved [B, T, H, 3*D] tensor, as the model
    splits its fused qkv projection, or (``broadcast`` 'heads' or 'batch')
    with k and v of one head or batch row expanded to [B, Tk, H, D]."""
    import torch
    rng = np.random.RandomState(seed)
    cast = dict(device=device, dtype=getattr(torch, dtype))
    if interleaved:
        fused = rng.standard_normal((B, Tq, H, 3 * D)).astype(np.float32)
        return torch.from_numpy(fused).to(**cast).split(D, dim=-1)
    kv_shape = {None: (B, Tk, H, D), 'heads': (B, Tk, 1, D),
                'batch': (1, Tk, H, D)}[broadcast]
    q = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    k = rng.standard_normal(kv_shape).astype(np.float32)
    v = rng.standard_normal(kv_shape).astype(np.float32)
    q, k, v = (torch.from_numpy(a).to(**cast) for a in (q, k, v))
    return q, k.expand(B, Tk, H, D), v.expand(B, Tk, H, D)


def excess(got, want, atol, rtol):
    """max(|got - want| - rtol*|want|); <= atol means within tolerance."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() - rtol * want.abs()).max())


def kernel_vs_plain(device):
    import torch
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    device = torch.device(device)
    errs = {}
    for label, B, Tq, Tk, H, D, dtype, causal, want_body in CASES:
        q, k, v = qkv(B, Tq, Tk, H, D, dtype, device,
                      interleaved=label == SERVED_LAYOUT,
                      broadcast=BROADCAST.get(label))
        before = dict(ck.flash_fwd.launches_by_body)
        out, lse = ck.flash_fwd(q, k, v, causal)
        ran = {b for b, n in ck.flash_fwd.launches_by_body.items()
               if n != before[b]}
        ref_out, ref_lse = ck.flash_attention_lse_ref(q, k, v, causal)
        atol, rtol = TOL[dtype]
        err = float((out.float() - ref_out.float()).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        ok = (bool(torch.isfinite(out).all())
              and excess(out, ref_out, atol, rtol) <= atol
              and excess(lse, ref_lse, *LSE_TOL) <= LSE_TOL[0]
              and ran == ({want_body} if device.type == 'cuda' else set()))
        log('  %-26s %-8s causal=%d body=%-6s max|out err| %.3e  '
            'max|lse err| %.3e  %s' % (label, dtype, causal, want_body, err,
                                       lse_err, 'ok' if ok else 'FAIL'))
        check(ok, 'kernel disagrees with its plain version: %s causal=%d '
              'body=%s (ran %s)' % (label, causal, want_body, sorted(ran)))
        errs[(label, causal)] = err
        del q, k, v, out, lse, ref_out, ref_lse

    # empty: zeros and no launch
    for shape_q, shape_kv in (((0, 8, 2, 16), (0, 8, 2, 16)),
                              ((2, 8, 0, 16), (2, 8, 0, 16)),
                              ((2, 0, 2, 16), (2, 8, 2, 16))):
        before = ck.flash_fwd.launches
        q = torch.zeros(shape_q, device=device)
        k = torch.zeros(shape_kv, device=device)
        out, lse = ck.flash_fwd(q, k, k, True)
        check(out.shape == q.shape and lse.shape == (q.shape[0], q.shape[2],
                                                     q.shape[1])
              and ck.flash_fwd.launches == before, 'empty case %s' % (shape_q,))
    # the two ValueError cases
    for shape_q, shape_kv, causal in (((1, 8, 2, 16), (1, 4, 2, 16), True),
                                      ((1, 8, 2, 16), (1, 0, 2, 16), False)):
        q = torch.zeros(shape_q, device=device)
        k = torch.zeros(shape_kv, device=device)
        try:
            ck.flash_fwd(q, k, k, causal)
        except ValueError:
            pass
        else:
            check(False, 'no ValueError for q %s, k %s' % (shape_q, shape_kv))
    log('  empty cases: zeros, no launch; causal Tq>Tk and Tk=0: ValueError')

    # gradient through the autograd Function vs the plain gradient.
    # Tolerance 1e-4: the backward recomputes through the plain version;
    # only the cotangent 2*out comes from the kernel (f32 sums reordered).
    q, k, v = qkv(1, 64, 64, 2, 32, 'float32', device, seed=3)
    grads = []
    for fn in (ck.flash_attention_lse, ck.flash_attention_lse_ref):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out, lse = fn(*leaves, True)
        ((out ** 2).sum() + lse.sum()).backward()
        grads.append([t.grad for t in leaves])
    gerr = max(float((a - b).abs().max()) for a, b in zip(*grads))
    log('  autograd grad vs plain grad: max err %.3e' % gerr)
    check(gerr <= 1e-4, 'gradient disagrees (%.3e)' % gerr)
    return errs


# ---------------------------------------------------------------------------
# (d) serving at full width
# ---------------------------------------------------------------------------

# Logits of the kernel path vs the reference forward on the plain attention,
# both bf16. Each layer's attention output may differ by a bf16 rounding (the
# kernel rounds p to bf16; bf16 resolves 2**-8 relative) and the matmuls run
# at other batch sizes (padded buckets vs the bare request), and 8 residual
# layers carry that into the logits: relative RMS error <= 2e-2. The next
# token must agree up to bf16 ties: the reference's logit at the served
# argmax lies within ARGMAX_SLACK of the reference's max. Single logits of
# the two paths differ by up to 2 bf16 ulps at the max logit's magnitude
# (16..32, an ulp of 0.125); the served argmax's reference logit can then
# sit twice that below the max: 4 ulps, 0.5. Exact agreement is printed too.
# The slack only guards the next token against ties; the relative RMS bound
# is the check that fails a wrong kernel (a wrong tile or mask moves every
# logit of the rows it touches, far past 2e-2).
LOGIT_REL_RMS = 2e-2
ARGMAX_SLACK = 0.5


def on_device(a, device):
    """A served bf16 answer (numpy, ml_dtypes.bfloat16) as an f32 tensor
    on ``device``."""
    import torch
    check(a.dtype.name == 'bfloat16', 'served logits are %s, not bfloat16'
          % a.dtype)
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
        .to(device).float()


def serve(device, cfg, rows_list, max_batch):
    import torch
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.serving import ServingEngine
    from mxnet_tpu_torch.transformer import (TransformerLM, init_params,
                                             params_from_jax)
    t0 = time.perf_counter()
    state = params_from_jax(init_params(cfg, seed=0))
    model = TransformerLM(cfg, dtype=torch.bfloat16, device=device)
    model.load_state_dict(state)
    ref = TransformerLM(cfg, dtype=torch.bfloat16, device=device,
                        attention=ck.flash_attention_ref)
    ref.load_state_dict(state)
    truth = TransformerLM(cfg, dtype=torch.float32, device=device,
                          attention=ck.flash_attention_ref)
    truth.load_state_dict(state)
    del state
    engine = ServingEngine.from_forward(
        model, [('tokens', (cfg.seq_len,), np.int32)],
        output_names=['logits'], max_batch=max_batch, device=device,
        name='bench_transformer')
    warmed = engine.warmup()
    log('  model built and %d buckets %s warm in %.1f s'
        % (warmed, engine.buckets, time.perf_counter() - t0))

    rng = np.random.RandomState(1)
    requests = [rng.randint(0, cfg.vocab, (r, cfg.seq_len)).astype(np.int32)
                for r in rows_list]
    n_chunks = sum(-(-r // engine.buckets[-1]) for r in rows_list)

    # the main path: counts are zeroed just before and read just after
    ck.flash_fwd.launches = 0
    ck.flash_fwd.launches_by_body = dict.fromkeys(ck._BODIES, 0)
    answers, latencies = [], []
    for req in requests:
        t = time.perf_counter()
        timings = {}
        chunks = engine.dispatch_rows(req, timings=timings)
        answers.append(engine.fetch_chunks(chunks, timings=timings)[0])
        latencies.append((time.perf_counter() - t, timings))
    launches = ck.flash_fwd.launches
    by_body = dict(ck.flash_fwd.launches_by_body)

    check(launches == cfg.n_layers * n_chunks
          and by_body['wgmma'] == launches,
          'flash launches %d (by body %s) != %d layers x %d chunks on the '
          'wgmma body' % (launches, by_body, cfg.n_layers, n_chunks))
    log('  %d requests (%s rows) in %d chunks: %d flash launches = %d layers '
        'x %d chunks, by body %s' % (len(requests), list(rows_list), n_chunks,
                                     launches, cfg.n_layers, n_chunks, by_body))

    worst = {'rel_rms': 0.0, 'agree': 1.0, 'max_abs': 0.0, 'top_gap': 0.0}
    with torch.inference_mode():
        for req, got in zip(requests, answers):
            got_t = on_device(got, device)
            check(got.shape == (req.shape[0], cfg.seq_len, cfg.vocab)
                  and bool(torch.isfinite(got_t).all()), 'logits shape/finite')
            want = ref(torch.from_numpy(req).to(device)).float()
            diff = got_t - want
            rel = float(diff.square().mean().sqrt() / want.square().mean().sqrt())
            pick = got_t.argmax(-1, keepdim=True)
            agree = float((pick[..., 0] == want.argmax(-1)).float().mean())
            gap = float((want.amax(-1) - want.gather(-1, pick)[..., 0]).max())
            worst['rel_rms'] = max(worst['rel_rms'], rel)
            worst['agree'] = min(worst['agree'], agree)
            worst['top_gap'] = max(worst['top_gap'], gap)
            worst['max_abs'] = max(worst['max_abs'], float(diff.abs().max()))
            del want, got_t, diff
    log('  logits vs plain-attention reference: worst rel RMS %.3e, '
        'max |err| %.3e, exact argmax agreement %.4f, reference logit at the '
        'served argmax at most %.4f below its max'
        % (worst['rel_rms'], worst['max_abs'], worst['agree'], worst['top_gap']))
    check(worst['rel_rms'] <= LOGIT_REL_RMS and worst['top_gap'] <= ARGMAX_SLACK,
          'served logits disagree with the reference forward')

    # Where the differences come from, on the first request: the same batch
    # through both bf16 paths (the kernel alone), and each bf16 path against
    # an f32 forward on the plain attention (which of the two is closer to
    # f32 arithmetic).
    with torch.inference_mode():
        tokens = torch.from_numpy(requests[0]).to(device)
        kern = model(tokens).float()
        plain = ref(tokens).float()
        exact = truth(tokens).float()

        def rel(a, b):
            return float((a - b).square().mean().sqrt() / b.square().mean().sqrt())

        log('  request 1 (%d rows), relative RMS: kernel path vs plain path at '
            'the same batch %.3e; vs the f32 forward: kernel path %.3e, plain '
            'bf16 path %.3e, served answer %.3e'
            % (tokens.shape[0], rel(kern, plain), rel(kern, exact),
               rel(plain, exact), rel(on_device(answers[0], device), exact)))
        del kern, plain, exact
    del truth
    return model, ref, launches, latencies, worst


# ---------------------------------------------------------------------------
# (g) row kernels vs plain versions
# ---------------------------------------------------------------------------

ROW_KERNELS = ('layernorm', 'rmsnorm', 'softmax', 'softmax_xent')
ROW_REPLACES = {'layernorm': 'mxnet_tpu/ops/pallas_kernels.py:290',
                'rmsnorm': 'mxnet_tpu/ops/pallas_kernels.py:284',
                'softmax': 'mxnet_tpu/ops/pallas_kernels.py:382',
                'softmax_xent': 'mxnet_tpu/ops/pallas_kernels.py:412'}

# Tolerances of a row kernel against its plain version on the same inputs
# (|kernel - plain| <= atol + rtol * |plain|), with their reasons. Both
# compute in f32 with the row sums in another order (a few f32 ulps of the
# statistics), then round once to the output type:
# - f32 out (and xent's f32 loss, whatever its logits' type): 1e-5 / 1e-5;
# - bf16 out: one bf16 ulp of the value (rtol 2**-7: 2**-8 relative, up to
#   2**-7 just above a power of two), as a few f32 ulps can fall on either
#   side of a rounding boundary; atol 1e-6 near zero;
# - f16 out: one f16 ulp, rtol 2**-10; atol 1e-6 covers f16's subnormals
#   (softmax outputs below 6.1e-5 have an ulp of 6e-8).
# - rows with a mean of 1000 (LayerNorm): atol 2e-3 against the plain
#   version and against float64. An f32 row sum near 1e6 rounds at 0.06 an
#   add, so either mean may be off by ~1e-4, which moves (x - mean) * rstd
#   * gamma by a few 1e-4; the one-pass E[x^2] - mean^2 would be off by
#   about 1e-1 here.
ROW_TOL = {'float32': (1e-5, 1e-5), 'bfloat16': (1e-6, 2 ** -7),
           'float16': (1e-6, 2 ** -10)}
LARGE_MEAN_ATOL = 2e-3
# Gradients of each autograd Function (kernel forward) against the plain
# version's autograd gradient, f32: the norm and xent backwards recompute
# through the plain version (the same arithmetic) and the softmax backward
# reads the kernel's y; 1e-5.
ROW_GRAD_TOL = 1e-5


def model_shapes(cfg, batch=MAX_BATCH):
    """The row kernels' shapes on the model's path: its activations, one
    layer's attention scores, and its logits as [N, V]."""
    act = (batch, cfg.seq_len, cfg.d_model)
    return {'layernorm': act, 'rmsnorm': act,
            'softmax': (batch, cfg.n_heads, cfg.seq_len, cfg.seq_len),
            'softmax_xent': (batch * cfg.seq_len, cfg.vocab)}


def row_inputs(kernel, shape, dtype, device, seed=0, param_dtypes=None,
               offset=False, mean=0.0):
    """Arguments of ``kernel`` at ``shape``, from a seeded generator on
    ``device``: x (N(mean, 1.5), or the logits), then gamma/beta (f32 by
    default, else ``param_dtypes``), or the int32 labels with -1 and V
    among them. ``offset``: x is a contiguous view one element past an
    aligned start, so its rows are not 16-byte aligned."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = getattr(torch, dtype)
    numel = int(np.prod(shape))
    flat = (torch.randn(numel + 1, generator=gen, device=device) * 1.5
            + mean).to(dt)
    x = (flat[1:] if offset else flat[:numel]).view(shape)
    if kernel == 'softmax_xent':
        N, V = shape
        labels = torch.randint(0, V, (N,), generator=gen, device=device,
                               dtype=torch.int32)
        labels[::97] = -1
        labels[1::89] = V
        return [x, labels]
    D = shape[-1]
    gd, bd = param_dtypes or ('float32', 'float32')
    gamma = (torch.randn(D, generator=gen, device=device) * 0.5 + 1).to(
        getattr(torch, gd))
    beta = (torch.randn(D, generator=gen, device=device) * 0.1).to(
        getattr(torch, bd))
    return {'layernorm': [x, gamma, beta], 'rmsnorm': [x, gamma],
            'softmax': [x]}[kernel]


def row_fns(kernel):
    """(kernel wrapper, plain version, autograd Function) of ``kernel``."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    return {'layernorm': (ck.layernorm_fwd, ck.layernorm_ref, ck.fused_layernorm),
            'rmsnorm': (ck.rmsnorm_fwd, ck.rmsnorm_ref, ck.fused_rmsnorm),
            'softmax': (ck.softmax_fwd, ck.softmax_ref, ck.fused_softmax),
            'softmax_xent': (ck.softmax_xent_fwd, ck.softmax_xent_ref,
                             ck.softmax_xent)}[kernel]


def row_tol(kernel, dtype):
    return ROW_TOL['float32' if kernel == 'softmax_xent' else dtype]


def row_cases(cfg):
    """(kernel, label, shape, dtype, options) of phase (g)."""
    shapes = model_shapes(cfg)
    cases = []
    for kernel in ROW_KERNELS:
        for dtype in ('float32', 'bfloat16', 'float16'):
            cases.append((kernel, 'model shape', shapes[kernel], dtype, {}))
            for shape in ((1006, 32), (1006, 1000), (1006, 50), (7, 1000),
                          (0, 64)):
                cases.append((kernel, 'N=%d width %d' % shape, shape, dtype, {}))
            cases.append((kernel, 'odd offset', (1006, 1000), dtype,
                          {'offset': True}))
    for kernel in ('layernorm', 'rmsnorm'):
        cases.append((kernel, 'x bf16, gamma/beta f32', (1006, 1000),
                      'bfloat16', {}))
        cases.append((kernel, 'x f32, gamma bf16, beta f16', (1006, 1000),
                      'float32', {'param_dtypes': ('bfloat16', 'float16')}))
        cases.append((kernel, 'x f16, gamma/beta bf16', (1006, 1000),
                      'float16', {'param_dtypes': ('bfloat16', 'bfloat16')}))
    return cases


# The bodies of LayerNorm, RMSNorm and softmax at the model's row count
# (8 x 1024 rows): (label, width, dtype, offset, whether the rows are ones a
# register-row body takes). Rows of whole 16-byte vectors up to 4 KB that
# start 16-byte aligned take LayerNorm's warp body and the ring body of
# RMSNorm and softmax (REGISTER_BODY); every other row the block body.
BODY_CASES = [
    ('width 1024', 1024, 'bfloat16', False, True),
    ('width 2048', 2048, 'bfloat16', False, True),
    ('width 1000', 1000, 'bfloat16', False, True),
    ('width 1024', 1024, 'float32', False, True),
    ('width 50', 50, 'bfloat16', False, False),
    ('width 4096', 4096, 'bfloat16', False, False),
    ('odd offset', 1024, 'bfloat16', True, False),
]
BODY_KERNELS = ('layernorm', 'rmsnorm', 'softmax')
REGISTER_BODY = {'layernorm': 'warp', 'rmsnorm': 'ring', 'softmax': 'ring'}


def bodies_ran(fwd, before):
    """The bodies whose launch counts moved since ``before``."""
    return {k for k, n in fwd.launches_by_body.items() if n != before[k]}


def row_bodies_vs_plain(device, cfg):
    """Phase (g): each body of LayerNorm, RMSNorm and softmax on the rows it
    takes, with the body the wrapper picked."""
    import torch
    rows = MAX_BATCH * cfg.seq_len
    for kernel in BODY_KERNELS:
        fwd, ref, _ = row_fns(kernel)
        for i, (label, D, dtype, offset, fits) in enumerate(BODY_CASES):
            body = REGISTER_BODY[kernel] if fits else 'block'
            args = row_inputs(kernel, (rows, D), dtype, device, seed=60 + i,
                              offset=offset)
            before = dict(fwd.launches_by_body)
            got = fwd(*args)
            want = ref(*args)
            ran = bodies_ran(fwd, before)
            atol, rtol = ROW_TOL[dtype]
            err = float((got.float() - want.float()).abs().max())
            ok = (got.shape == want.shape and got.dtype == want.dtype
                  and bool(torch.isfinite(got).all())
                  and excess(got, want, atol, rtol) <= atol
                  and ran == ({body} if device.type == 'cuda' else set()))
            log('  %-12s %-30s %-8s %-22s body=%-5s max|err| %.3e  %s'
                % (kernel, label, dtype, (rows, D), body, err, 'ok' if ok else 'FAIL'))
            check(ok, '%s %s %s disagrees with its plain version or ran %s'
                  % (kernel, label, dtype, sorted(ran)))
            del args, got, want


def edge_rows(kernel, cfg, device):
    """x of ``kernel`` (and gamma) at the model's row width with edge rows,
    and a description of them. softmax: one layer's causal scores of one
    sequence, [n_heads, S, S] bf16 with the upper triangle -inf, then one
    row all -inf and one holding a NaN; RMSNorm: [8 x 1024, D] bf16 with
    rows all zero, all -inf and holding a NaN."""
    import torch
    if kernel == 'softmax':
        S = cfg.seq_len
        x, = row_inputs('softmax', (cfg.n_heads, S, S), 'bfloat16', device, seed=70)
        mask = torch.ones(S, S, dtype=torch.bool, device=device).triu(1)
        x.masked_fill_(mask, float('-inf'))
        x[0, 5] = float('-inf')
        x[-1, S - 3, 3] = float('nan')
        return [x], 'causal -inf upper triangle, a row all -inf, a NaN row'
    x, g = row_inputs('rmsnorm', (MAX_BATCH * cfg.seq_len, cfg.d_model),
                      'bfloat16', device, seed=71)
    x[3] = 0
    x[4] = float('-inf')
    x[5, 17] = float('nan')
    return [x, g], 'a zero row, a row all -inf, a NaN row'


def nan_aware_excess(got, want, atol, rtol):
    """(whether got and want are NaN at the same places, excess of the rest
    as :func:`excess` gives it)."""
    import torch
    got, want = got.float(), want.float()
    nan = torch.isnan(want)
    same = bool(torch.equal(torch.isnan(got), nan))
    keep = ~nan
    return same, excess(got[keep], want[keep], atol, rtol)


def edge_rows_vs_plain(device, cfg):
    """Phase (g): RMSNorm and softmax on rows with -inf, NaN and zeros, on
    both bodies (the ring body on aligned rows, the block body on the same
    rows one element past an aligned start), against the plain version with
    NaN positions equal. A -inf score must give exactly 0."""
    import torch
    for kernel in ('softmax', 'rmsnorm'):
        fwd, ref, _ = row_fns(kernel)
        args, what = edge_rows(kernel, cfg, device)
        x = args[0]
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
        shifted = flat[1:].view(x.shape)
        shifted.copy_(x)
        for body, xin in ((REGISTER_BODY[kernel], x), ('block', shifted)):
            before = dict(fwd.launches_by_body)
            got = fwd(xin, *args[1:])
            want = ref(xin, *args[1:])
            ran = bodies_ran(fwd, before)
            atol, rtol = ROW_TOL['bfloat16']
            same_nan, ex = nan_aware_excess(got, want, atol, rtol)
            zeros = ''
            if kernel == 'softmax':     # masked scores of rows with a finite max
                masked = torch.isinf(xin) & ~torch.isnan(want)
                zeros = ', -inf scores exactly 0 %s' % bool((got[masked] == 0).all())
            ok = (same_nan and ex <= atol and not zeros.endswith('False')
                  and got.dtype == xin.dtype
                  and ran == ({body} if device.type == 'cuda' else set()))
            log('  %-12s edge rows %-22s body=%-5s NaN at the same places %s%s, '
                'excess %.3e  %s' % (kernel, tuple(x.shape), body, same_nan, zeros,
                                     ex, 'ok' if ok else 'FAIL'))
            check(ok, '%s edge rows (%s) on the %s body disagree with the plain '
                  'version or ran %s' % (kernel, what, body, sorted(ran)))
            del got, want
        del args, x, flat, shifted


def row_kernels_vs_plain(device, cfg):
    """Phase (g)."""
    import torch
    for i, (kernel, label, shape, dtype, opts) in enumerate(row_cases(cfg)):
        fwd, ref, _ = row_fns(kernel)
        args = row_inputs(kernel, shape, dtype, device, seed=i, **opts)
        before = fwd.launches
        got = fwd(*args)
        want = ref(*args)
        atol, rtol = row_tol(kernel, dtype)
        err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
        ok = (got.shape == want.shape and got.dtype == want.dtype
              and bool(torch.isfinite(got).all())
              and (got.numel() == 0 or excess(got, want, atol, rtol) <= atol)
              and fwd.launches == before + (1 if got.numel() and device.type == 'cuda' else 0))
        log('  %-12s %-30s %-8s %-22s max|err| %.3e  %s'
            % (kernel, label, dtype, tuple(shape), err, 'ok' if ok else 'FAIL'))
        check(ok, '%s disagrees with its plain version: %s %s %s'
              % (kernel, label, dtype, tuple(shape)))
        del args, got, want

    row_bodies_vs_plain(device, cfg)
    edge_rows_vs_plain(device, cfg)

    # the two-pass variance: rows with a mean of 1000, against float64 too
    for dtype in ('float32', 'bfloat16'):
        x, g, b = row_inputs('layernorm', (64, cfg.d_model), dtype, device,
                             seed=99, mean=1000.0)
        got = row_fns('layernorm')[0](x, g, b)
        plain = row_fns('layernorm')[1](x, g, b)
        x64 = x.double()
        y64 = ((x64 - x64.mean(-1, keepdim=True))
               * torch.rsqrt(x64.var(-1, unbiased=False, keepdim=True) + 1e-5)
               * g.double() + b.double())
        rtol = ROW_TOL[dtype][1] if dtype == 'bfloat16' else 0.0  # y's rounding
        e_plain = excess(got, plain, LARGE_MEAN_ATOL, rtol)
        e64 = excess(got, y64, LARGE_MEAN_ATOL, rtol)
        log('  layernorm    rows with mean 1000             %-8s |err| beyond '
            'rounding: vs plain %.3e, vs float64 %.3e' % (dtype, e_plain, e64))
        check(e_plain <= LARGE_MEAN_ATOL and e64 <= LARGE_MEAN_ATOL,
              'layernorm loses the variance of rows with a large mean')

    # types the kernels do not take raise
    bad = [(row_fns('softmax')[0], [torch.zeros(4, 8, dtype=torch.int32,
                                                device=device)]),
           (row_fns('softmax_xent')[0], [torch.zeros(4, 8, device=device),
                                         torch.zeros(4, device=device)])]
    if device.type == 'cuda':
        for fn, args in bad:
            try:
                fn(*args)
            except TypeError:
                continue
            check(False, '%s took a type it does not take' % fn.__name__)
        log('  int x and float labels: TypeError')

    # each autograd Function's gradient vs the plain gradient (f32)
    for kernel in ROW_KERNELS:
        _, ref, function = row_fns(kernel)
        shape = (64, 50) if kernel == 'softmax_xent' else (64, 96)
        args = row_inputs(kernel, shape, 'float32', device, seed=7)
        w = torch.randn(shape[:1] if kernel == 'softmax_xent' else shape,
                        generator=torch.Generator(device=device).manual_seed(8),
                        device=device)
        grads = []
        for fn in (function, ref):
            leaves = [a.clone().requires_grad_() if a.is_floating_point() else a
                      for a in args]
            (fn(*leaves) * w).sum().backward()
            grads.append([a.grad for a in leaves if a.is_floating_point()])
        gerr = max(float((a - b).abs().max()) for a, b in zip(*grads))
        log('  %-12s autograd grad vs plain grad: max err %.3e' % (kernel, gerr))
        check(gerr <= ROW_GRAD_TOL, '%s gradient disagrees (%.3e)' % (kernel, gerr))


# ---------------------------------------------------------------------------
# (h) the NDArray path at full width
# ---------------------------------------------------------------------------

# bench's loss through the kernel against the plain version's mean(lse -
# gold) on the same f32 logits: each row's loss (about 10) agrees to a few
# f32 ulps, and the sums over 65,536 rows run in another order: 1e-5
# relative.
LOSS_RTOL = 1e-5


def nd_path(device, cfg, model):
    """Phase (h). Returns ({wrapper name: launches}, {kernel: max |err|
    against the plain version})."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.transformer import bench_batch
    ctx = mt.gpu(device.index or 0) if device.type == 'cuda' else mt.cpu()
    shapes = model_shapes(cfg)
    x, gamma, beta = row_inputs('layernorm', shapes['layernorm'], 'bfloat16',
                                device, seed=11)
    scores, = row_inputs('softmax', shapes['softmax'], 'bfloat16', device,
                         seed=12)
    tokens, labels = bench_batch(cfg, MAX_BATCH, seed=0)
    tokens = torch.from_numpy(tokens).to(device)
    N, V = tokens.numel(), cfg.vocab
    lab = nd.array(labels.reshape(-1), ctx=ctx)
    x_nd, g_nd, b_nd = (nd.from_torch(t, ctx) for t in (x, gamma, beta))
    s_nd = nd.from_torch(scores, ctx)

    counters = [ck.flash_fwd] + [row_fns(k)[0] for k in ROW_KERNELS]
    # the main path: counts are zeroed just before and read just after
    for fwd in counters:
        fwd.launches = 0
        if hasattr(fwd, 'launches_by_body'):
            fwd.launches_by_body = dict.fromkeys(fwd.launches_by_body, 0)
    ln = nd.LayerNorm(x_nd, g_nd, b_nd, eps=1e-5)
    sm = nd.softmax(s_nd)
    rms = mt.ops.fused_rmsnorm(x, gamma)
    with torch.no_grad():
        logits = model(tokens).float()               # bench.py:270
    loss = nd.softmax_cross_entropy(nd.from_torch(logits.reshape(-1, V), ctx),
                                    lab)
    loss.wait_to_read()
    launches = {fwd.__name__: fwd.launches for fwd in counters}
    bodies = {kernel: dict(row_fns(kernel)[0].launches_by_body)
              for kernel in BODY_KERNELS}

    want = {'flash_fwd': cfg.n_layers, 'layernorm_fwd': 1, 'rmsnorm_fwd': 1,
            'softmax_fwd': 1, 'softmax_xent_fwd': 1}
    on_card = device.type == 'cuda'
    # each on its register-row body; plain versions on the CPU
    want_bodies = {kernel: {b: int(on_card and b == REGISTER_BODY[kernel])
                            for b in bodies[kernel]} for kernel in BODY_KERNELS}
    if not on_card:
        want = dict.fromkeys(want, 0)
    log('  launches: %s; by body %s' % (launches, bodies))
    check(launches == want and bodies == want_bodies,
          'launch counts %s (by body %s) != %s (%s)'
          % (launches, bodies, want, want_bodies))

    errs = {}
    for kernel, got, ref_args in (('layernorm', ln.handle, (x, gamma, beta)),
                                  ('softmax', sm.handle, (scores,)),
                                  ('rmsnorm', rms, (x, gamma))):
        want_t = row_fns(kernel)[1](*ref_args)
        atol, rtol = ROW_TOL['bfloat16']
        errs[kernel] = float((got.float() - want_t.float()).abs().max())
        ok = (got.dtype == torch.bfloat16 and got.shape == want_t.shape
              and bool(torch.isfinite(got).all())
              and excess(got, want_t, atol, rtol) <= atol)
        log('  nd %-10s %-22s bf16: max|err| vs plain %.3e  %s'
            % (kernel, tuple(got.shape), errs[kernel], 'ok' if ok else 'FAIL'))
        check(ok, 'nd path %s disagrees with its plain version' % kernel)
        del want_t

    labels_t = torch.from_numpy(labels.reshape(-1)).to(device)
    got_loss = float(loss.asscalar()) / N
    per_row = ck.softmax_xent_ref(logits.reshape(-1, V), labels_t)
    plain_loss = float(per_row.mean())
    kernel_rows = ck.softmax_xent_fwd(logits.reshape(-1, V), labels_t)
    errs['softmax_xent'] = float((kernel_rows - per_row).abs().max())
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels_t.view(tokens.shape).long()[..., None])[..., 0]
    bench_loss = float((lse - gold).mean())
    log('  bench loss at full width (%d tokens, V=%d): nd.softmax_cross_entropy'
        ' / N %.6f, plain mean(lse - gold) %.6f, torch.logsumexp form %.6f, '
        'max|row err| %.3e' % (N, V, got_loss, plain_loss, bench_loss,
                               errs['softmax_xent']))
    check(np.isfinite(got_loss) and loss.shape == () and loss.dtype == np.float32
          and abs(got_loss - plain_loss) <= LOSS_RTOL * abs(plain_loss),
          'bench loss through the kernel disagrees with the plain version')
    return launches, errs


# ---------------------------------------------------------------------------
# (i) mx.rtc on the card: user kernels compiled at run time by NVRTC (K7)
# ---------------------------------------------------------------------------

RTC_REPLACES = 'mxnet_tpu/rtc.py:79'

# The user kernels, written as a user of mx.rtc writes them: CUDA C bodies
# over the declared inputs and outputs, each of which comes with its
# <name>_ndim and <name>_dims[] constants.
# k7a: the reference's own mx.rtc test kernel, as it was written.
K7A_REFERENCE = """
__shared__ float s_rec[10];
s_rec[threadIdx.x] = x[threadIdx.x];
y[threadIdx.x] = expf(s_rec[threadIdx.x]*5.0);
"""
# k7b: the JAX package's test kernel `triple` (tests/unittest/test_rtc.py).
K7B_TRIPLE = """
const int i = blockIdx.x * blockDim.x + threadIdx.x;
if (i < x_dims[0]) y[i] = x[i] * 3.0f;
"""
# k7c: bench's rms (transformer._rms): normalise in f32, round to x's type,
# then scale by g. One row a block, blocks of at most 256 threads (a power
# of two), the sum of squares reduced in shared memory.
K7C_RMS = """
const int D = x_dims[x_ndim - 1];
const __nv_bfloat16* xr = x + (long long)blockIdx.x * D;
__nv_bfloat16* yr = y + (long long)blockIdx.x * D;
__shared__ float part[256];
float s = 0.f;
for (int j = threadIdx.x; j < D; j += blockDim.x) {
  const float v = __bfloat162float(xr[j]);
  s += v * v;
}
part[threadIdx.x] = s;
__syncthreads();
for (int w = blockDim.x / 2; w > 0; w >>= 1) {
  if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
  __syncthreads();
}
const float inv = rsqrtf(part[0] / D + 1e-6f);
for (int j = threadIdx.x; j < D; j += blockDim.x) {
  const float n = __bfloat162float(__float2bfloat16_rn(__bfloat162float(xr[j]) * inv));
  yr[j] = __float2bfloat16_rn(n * __bfloat162float(g[j]));
}
"""
# k7d: GELU, tanh form, over every element of h (the MLP's hidden
# activations), f32 inside, grid-stride so that any grid covers it.
K7D_GELU = """
long long n = 1;
for (int d = 0; d < h_ndim; ++d) n *= h_dims[d];
for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
     i += (long long)gridDim.x * blockDim.x) {
  const float v = __bfloat162float(h[i]);
  const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
  y[i] = __float2bfloat16_rn(0.5f * v * (1.0f + tanhf(u)));
}
"""
RMS_BLOCK = 256

# Tolerances of each user kernel against its plain version on the same
# inputs (|kernel - plain| <= atol + rtol * |plain|), with their reasons:
# - k7a, k7b (f32): expf is within 2 ulps of exp, and x * 3 is exact:
#   rtol 1e-6 (about 8 f32 ulps), atol 0.
# - k7d (bf16 out, one rounding of an f32 value): one bf16 ulp (rtol 2**-7,
#   atol 1e-6). tanhf and fused multiply-adds can move the f32 value across
#   a bf16 rounding boundary; atol covers GELU's outputs near zero.
# - k7c (bf16 out, two roundings, as bench rounds): two bf16 ulps (rtol
#   2**-6, atol 1e-6). The f32 sums of squares differ in their order, so
#   the normalised value n may round to the neighbouring bf16 value (one ulp
#   of n, up to 2**-7 relative); n * g then rounds again, so one ulp does
#   not hold (a few elements in a million differ by two).
# For both, fewer than RTC_DIFF_SHARE of the elements may differ at all: a
# kernel that is off everywhere fails that even inside the ulps. The limit
# is about 20 times the readings on an H100 (k7c: 37 of 8.4M elements,
# 4.41e-6; k7d: none), so a body that moves its f32 value by a few parts in
# a million (an eps of 1e-5 for bench's 1e-6) fails it.
RTC_TOL = {'rtc_k7a_reference': (0.0, 1e-6), 'rtc_k7b_triple': (0.0, 1e-6),
           'rtc_k7c_rms': (1e-6, 2 ** -6), 'rtc_k7d_gelu': (1e-6, 2 ** -7)}
RTC_DIFF_SHARE = 1e-4
# f32 operations an element: k7a mul, exp; k7b mul; k7c mul, add; mul, mul;
# k7d 3 mul, add, mul, tanh, add, 2 mul (tanh counted as one).
RTC_OPS_PER_ELEMENT = {'rtc_k7a_reference': 2, 'rtc_k7b_triple': 1,
                       'rtc_k7c_rms': 4, 'rtc_k7d_gelu': 9}
# The step on the NDArray surface against the plain chain (bench's _rms and
# the plain GELU in torch): the user kernels' outputs differ from the plain
# versions by a bf16 ulp in a few elements per million, which the matmul and
# the sum spread. It read a relative RMS of 2.7e-5 on an H100; the limit is
# about 20 times that. The step's bf16 total has a limit of its own (its
# rounding to bf16 comes first).
STEP_REL_RMS = 5e-4


def rtc_kernels(cfg, batch=MAX_BATCH):
    """{name: (body, inputs, outputs, grid_dims, block_dims)} of k7a-k7d at
    the shapes of the main path; inputs and outputs are (name, shape,
    dtype); grid_dims None takes Rtc's default geometry."""
    act = (batch, cfg.seq_len, cfg.d_model)
    hid = (batch, cfg.seq_len, 4 * cfg.d_model)
    rows = batch * cfg.seq_len
    return {
        'rtc_k7a_reference': (K7A_REFERENCE, [('x', (10,), 'float32')],
                              [('y', (10,), 'float32')], (1, 1, 1), (10, 1, 1)),
        'rtc_k7b_triple': (K7B_TRIPLE, [('x', (8,), 'float32')],
                           [('y', (8,), 'float32')], None, None),
        'rtc_k7c_rms': (K7C_RMS, [('x', act, 'bfloat16'),
                                  ('g', (cfg.d_model,), 'bfloat16')],
                        [('y', act, 'bfloat16')], (rows, 1, 1),
                        (RMS_BLOCK, 1, 1)),
        'rtc_k7d_gelu': (K7D_GELU, [('h', hid, 'bfloat16')],
                         [('y', hid, 'bfloat16')], None, None),
    }


def make_rtc(name, spec, ctx):
    """An Rtc(mode='cuda') of ``spec`` (see :func:`rtc_kernels`), its
    arguments declared by NDArrays on ``ctx``."""
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.rtc import Rtc
    body, ins, outs, _, _ = spec
    return Rtc(name, [(n, nd.zeros(s, ctx, d)) for n, s, d in ins],
               [(n, nd.zeros(s, ctx, d)) for n, s, d in outs], body, mode='cuda')


def rtc_plain(name):
    """The plain PyTorch version of user kernel ``name``."""
    import torch
    from mxnet_tpu_torch.transformer import _rms

    def gelu(h):
        v = h.float()
        u = 0.7978845608028654 * (v + 0.044715 * v * v * v)
        return (0.5 * v * (1.0 + torch.tanh(u))).to(h.dtype)
    return {'rtc_k7a_reference': lambda x: torch.exp(x * 5.0),
            'rtc_k7b_triple': lambda x: x * 3.0,
            'rtc_k7c_rms': _rms, 'rtc_k7d_gelu': gelu}[name]


def rtc_library(name, args):
    """One PyTorch call computing the user kernel's function (a yardstick
    only; the port never calls it), or None where there is none. k7a's has
    two, x * 5 and then exp: torch has no one call for exp(5 x)."""
    import torch
    import torch.nn.functional as F
    if name == 'rtc_k7a_reference':
        return lambda: torch.exp(args[0] * 5.0)
    if name == 'rtc_k7b_triple':
        return lambda: torch.mul(args[0], 3.0)
    if name == 'rtc_k7d_gelu':
        return lambda: F.gelu(args[0], approximate='tanh')
    return None


def rtc_inputs(name, spec, device, seed):
    """Seeded inputs of user kernel ``name`` at its shapes."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for arg, shape, dtype in spec[1]:
        t = torch.randn(shape, generator=gen, device=device)
        if arg == 'g':
            t = t * 0.5 + 1.0
        elif name == 'rtc_k7d_gelu':
            t = t * 2.0
        elif name == 'rtc_k7a_reference':
            t = t.clamp(-1.0, 1.0)
        out.append(t.to(getattr(torch, dtype)))
    return out


def push(rtc, spec, args, device):
    """Push ``args`` (tensors) through ``rtc``; its output tensors."""
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.context import Context
    ctx = Context('gpu', device.index or 0)
    outs = [nd.zeros(s, ctx, d) for _, s, d in spec[2]]
    rtc.push([nd.from_torch(a, ctx) for a in args], outs, spec[3], spec[4])
    return [o.handle for o in outs]


def rtc_engine_checks(device, cfg):
    """NVRTC's library, a first compile and a cached one, the compile error
    and the launch-geometry error."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import MXNetError, nd
    from mxnet_tpu_torch.ops import nvrtc
    from mxnet_tpu_torch.rtc import Rtc
    info = nvrtc.info()
    log('  NVRTC %d.%d from %s, include %s, arch %s'
        % (*info['version'], info['path'], info['include'], info['arch']))
    ctx = mt.gpu(device.index or 0)
    spec = rtc_kernels(cfg)['rtc_k7c_rms']
    args = [nd.from_torch(a, ctx)
            for a in rtc_inputs('rtc_k7c_rms', spec, device, seed=30)]
    outs = [nd.zeros(spec[2][0][1], ctx, 'bfloat16')]
    times = []
    for _ in range(2):            # the second Rtc of the same source
        rtc = make_rtc('rtc_k7c_rms', spec, ctx)
        before = nvrtc.stats['compiles']
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rtc.push(args, outs, *spec[3:])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        compiled = nvrtc.stats['compiles'] - before
        check(compiled == (1 if len(times) == 1 else 0),
              'push %d compiled %d times' % (len(times), compiled))
    n = 200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        rtc.push(args, outs, *spec[3:])
    torch.cuda.synchronize()
    steady_us = (time.perf_counter() - t0) / n * 1e6
    log('  k7c push and kernel, host clock: first %.1f ms (NVRTC compile and '
        'module load %.1f ms); a second Rtc of the same source %.3f ms, no '
        'compile; %d pushes of one Rtc back to back: %.1f us a push'
        % (times[0], nvrtc.stats['compile_ms'], times[1], n, steady_us))

    x, y = nd.zeros((4,), ctx), nd.zeros((4,), ctx)
    bad = Rtc('rtc_syntax_error', [('x', x)], [('y', y)],
              'y[threadIdx.x] = x[threadIdx.x] +;', mode='cuda')
    try:
        bad.push([x], [y])
    except MXNetError as e:
        msg = str(e)
        check('rtc_syntax_error' in msg and 'error' in msg,
              "the compile error does not carry NVRTC's log: %s" % msg)
        log("  a body with a syntax error: MXNetError with NVRTC's log: %s"
            % ' | '.join(ln.strip() for ln in msg.splitlines()
                         if 'error' in ln)[:300])
    else:
        check(False, 'a body with a syntax error compiled')
    before = nvrtc.launch.launches
    try:
        rtc.push(args, outs, grid_dims=(1,), block_dims=(2048,))
    except ValueError as e:
        log('  a 2048-thread block: ValueError before any launch (%s)' % e)
    else:
        check(False, 'a 2048-thread block was taken')
    check(nvrtc.launch.launches == before, 'a refused geometry launched')
    cpu_x, cpu_y = nd.zeros((4,), mt.cpu()), nd.zeros((4,), mt.cpu())
    try:
        Rtc('rtc_on_cpu', [('x', cpu_x)], [('y', cpu_y)], 'y[0] = x[0];',
            mode='cuda').push([cpu_x], [cpu_y])
    except ValueError:
        log("  CPU tensors: ValueError, nothing runs in the kernel's place")
    else:
        check(False, "mode='cuda' ran on CPU tensors")
    check(nvrtc.launch.launches == before, 'a refused push launched')


def first_mlp_input(model, tokens):
    """Layer 0 of the model up to its MLP: the residual stream after
    attention, which the MLP's pre-norm reads."""
    from mxnet_tpu_torch.transformer import HEAD_DIM, _rms
    B, S = tokens.shape
    H = model.cfg.n_heads
    blk = model.layers[0]
    x = model.embed[tokens]
    q, k, v = (_rms(x, blk.g1) @ blk.wqkv).view(B, S, H, 3 * HEAD_DIM) \
        .split(HEAD_DIM, dim=-1)
    a = model.attention(q, k, v, causal=True)
    return x + a.reshape(B, S, H * HEAD_DIM) @ blk.wo


def rel_rms(a, b):
    a, b = a.float(), b.float()
    return float((a - b).square().mean().sqrt() / b.square().mean().sqrt())


def rtc_path(device, cfg, model):
    """Phase (i)'s main path: an imperative step on gpu(0) at full width
    through the nd surface and the user kernels. Returns ({kernel:
    launches}, {kernel: Rtc})."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ops import nvrtc
    from mxnet_tpu_torch.transformer import bench_batch
    ctx = mt.gpu(device.index or 0)
    specs = rtc_kernels(cfg)
    rtcs = {name: make_rtc(name, spec, ctx) for name, spec in specs.items()}
    tokens = torch.from_numpy(bench_batch(cfg, MAX_BATCH, seed=0)[0]).to(device)
    blk = model.layers[0]
    with torch.no_grad():
        resid = first_mlp_input(model, tokens)
    g2, wup = blk.g2.detach(), blk.wup.detach()
    act = tuple(resid.shape)
    hid = act[:-1] + (wup.shape[1],)

    # the main path: counts are zeroed just before and read just after
    for r in rtcs.values():
        r.launches = 0
    nvrtc.launch.launches = 0
    # the reference's mx.rtc usage: fill with x[:] = 1, push, read y
    x = nd.zeros((10,), ctx)
    x[:] = 1
    y = nd.zeros((10,), ctx)
    rtcs['rtc_k7a_reference'].push([x], [y], *specs['rtc_k7a_reference'][3:])
    t = nd.arange(0, 8, ctx=ctx)
    t3 = nd.zeros((8,), ctx)
    rtcs['rtc_k7b_triple'].push([t], [t3])
    # layer 0's MLP at full width: pre-norm and GELU through user kernels
    acts = nd.zeros(act, ctx, 'bfloat16')
    acts[:] = nd.from_torch(resid, ctx)
    normed = nd.zeros(act, ctx, 'bfloat16')
    rtcs['rtc_k7c_rms'].push([acts, nd.from_torch(g2, ctx)], [normed],
                             *specs['rtc_k7c_rms'][3:])
    hidden = nd.from_torch(normed.handle @ wup, ctx)
    gelu = nd.zeros(hid, ctx, 'bfloat16')
    rtcs['rtc_k7d_gelu'].push([hidden], [gelu])
    mix = gelu * 0.5 + hidden
    row = mix[0, 3, :4]
    total = mix.sum()
    scaled = y + t3[1:3].sum()
    nd.waitall()
    launches = {name: r.launches for name, r in rtcs.items()}
    log('  launches: %s (NVRTC launches %d)' % (launches, nvrtc.launch.launches))
    check(launches == dict.fromkeys(rtcs, 1) and nvrtc.launch.launches == 4,
          'user-kernel launches %s' % launches)

    # the step against torch on the same tensors, and against the plain chain
    e5 = torch.exp(torch.tensor(5.0, device=device))
    want_t3 = torch.arange(8, dtype=torch.float32, device=device) * 3
    check(bool(torch.allclose(y.handle, e5.expand(10), rtol=1e-6, atol=0))
          and bool(torch.equal(t3.handle, want_t3))
          and bool(torch.equal(acts.handle, resid)),
          'k7a/k7b or the x[:] fill disagree')
    want_mix = gelu.handle * 0.5 + hidden.handle
    check(bool(torch.equal(mix.handle, want_mix))
          and bool(torch.equal(row.handle, want_mix[0, 3, :4]))
          and total.shape == (1,) and total.handle.dtype == want_mix.dtype
          and bool(torch.equal(total.handle, want_mix.sum().reshape(1)))
          and bool(torch.allclose(scaled.handle, e5 + 9.0, rtol=1e-6, atol=0)),
          'the nd step disagrees with torch on the same tensors')
    with torch.no_grad():
        plain_hidden = rtc_plain('rtc_k7c_rms')(resid, g2) @ wup
        plain_mix = rtc_plain('rtc_k7d_gelu')(plain_hidden) * 0.5 + plain_hidden
    got_sum = float(total.asscalar())
    want_sum = float(plain_mix.float().sum())
    abs_sum = float(plain_mix.float().abs().sum())
    err_mix = rel_rms(mix.handle, plain_mix)
    # the total is a bf16 value: rounded once, by up to half a bf16 ulp of
    # the f32 total (2**(e - 9) for a total in [2**(e-1), 2**e)), beside
    # which the user kernels' few differing elements spread as above
    sum_tol = 2.0 ** (math.frexp(want_sum)[1] - 9) + STEP_REL_RMS * abs_sum
    log('  step at full width (%s -> %s bf16): x[:] fill exact; nd ops equal '
        'torch on the same tensors; vs the plain chain: rel RMS %.3e, sum '
        '%.6g vs %.6g (|diff| %.6g, limit %.6g; |diff| / sum|x| %.3e)'
        % (act, hid, err_mix, got_sum, want_sum, abs(got_sum - want_sum),
           sum_tol, abs(got_sum - want_sum) / abs_sum))
    check(err_mix <= STEP_REL_RMS and abs(got_sum - want_sum) <= sum_tol
          and bool(torch.isfinite(mix.handle).all()),
          'the step disagrees with the plain chain')
    return launches, rtcs


def rtc_vs_plain(device, cfg, rtcs):
    """Each user kernel against its plain version on seeded inputs at the
    main path's shapes. Returns {kernel: max |err|}."""
    import torch
    errs = {}
    for i, (name, spec) in enumerate(rtc_kernels(cfg).items()):
        args = rtc_inputs(name, spec, device, seed=40 + i)
        got, = push(rtcs[name], spec, args, device)
        want = rtc_plain(name)(*args)
        atol, rtol = RTC_TOL[name]
        errs[name] = float((got.float() - want.float()).abs().max())
        share = float((got != want).float().mean())
        ok = (got.shape == want.shape and got.dtype == want.dtype
              and bool(torch.isfinite(got).all())
              and excess(got, want, atol, rtol) <= atol
              and share < RTC_DIFF_SHARE)
        log('  %-18s %-22s %-8s max|err| vs plain %.3e, %.2e of the elements '
            'differ  %s' % (name, tuple(got.shape),
                            str(got.dtype).replace('torch.', ''), errs[name],
                            share, 'ok' if ok else 'FAIL'))
        check(ok, '%s disagrees with its plain version' % name)
        del args, got, want
    return errs


def rtc_times(device, cfg, rtcs):
    """Each user kernel at the main path's shapes from a cold L2: its time
    through Rtc.push, its plain version's, one PyTorch call's and its
    bound."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.context import Context
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    out = {}
    ctx = Context('gpu', device.index or 0)
    for name, spec in rtc_kernels(cfg).items():
        args = rtc_inputs(name, spec, device, seed=50)
        # the NDArrays are made outside the timed call: nd.zeros fills on
        # the card, and Rtc.push itself only allocates its outputs
        ins = [nd.from_torch(a, ctx) for a in args]
        outs = [nd.zeros(s, ctx, d) for _, s, d in spec[2]]
        kernel_ms = device_ms(lambda: rtcs[name].push(ins, outs, *spec[3:]),
                              flush=flush)
        plain_ms = device_ms(lambda: rtc_plain(name)(*args), flush=flush)
        lib = rtc_library(name, args)
        library_ms = device_ms(lib, flush=flush) if lib is not None else None
        res = outs[0].handle
        nbytes = sum(a.numel() * a.element_size() for a in args) \
            + res.numel() * res.element_size()
        ops = RTC_OPS_PER_ELEMENT[name] * args[0].numel()
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = 'bytes' if t_bytes >= t_ops else 'operations'
        extra = ''
        if name == 'rtc_k7c_rms' and hasattr(F, 'rms_norm'):
            x, g = args
            extra = ('; F.rms_norm %.4f ms (not the same function: it does '
                     'not round before g)'
                     % device_ms(lambda: F.rms_norm(x, (x.shape[-1],), g, 1e-6),
                                 flush=flush))
        log('  %-18s %-22s kernel %.4f ms, plain %.4f ms, library %s ms, bound '
            '%.4g ms (%s: %d bytes), bound / kernel %.4g%s'
            % (name, tuple(args[0].shape), kernel_ms, plain_ms,
               'n/a' if library_ms is None else '%.4f' % library_ms, bound_ms,
               bound_by, nbytes, bound_ms / kernel_ms, extra))
        out[name] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        del args, res, ins, outs
    del flush
    return out


# ---------------------------------------------------------------------------
# (j) bench's training step at full width
# ---------------------------------------------------------------------------

# Bench's step at full width raises the loss for two steps before it falls:
# lr 0.01 overshoots along the first gradient (the loss along it is lowest
# near a tenth of that step, printed below), and the momentum carries the
# overshoot into step 3. Bench's own JAX step does the same at full width
# and depth (seen at batch 1 on the CPU). So the run takes five steps, and
# the loss must fall from step 1 to step 5.
TRAIN_STEPS = 5
HELD_STEPS = 3          # the steps whose losses are held to the reference
TIMED_STEPS = 5
# Tolerances of the kernel path's step against the same step on the plain
# attention, both on the card, with their reasons. The two differ only in
# the forward's attention: the kernel rounds p to bf16 before p.v, so each
# layer's output may differ by a bf16 rounding (phase (d) holds the two
# forwards' logits within a relative RMS of 2e-2); both backwards recompute
# through the plain version. Each bf16 gradient element carries those
# roundings through the backward, and the embedding's bf16 scatter-add runs
# with atomics, in another order on each run.
# - the loss of each of the first HELD_STEPS steps, a mean of 8,192 f32 rows
#   of logsumexp - gold: rtol 2e-3, the bound tests/test_torch_train_step.py
#   holds the port's three steps to against bench's own (measured there: 9e-5
#   to 4.4e-4). Later steps drift further apart, as any two trajectories of
#   a step that overshoots do, and are printed, not held;
# - the update each master took in step 1 (-lr * its gradient): a relative
#   RMS error of at most 3e-2 per tensor, the same test's bound (measured
#   there: 6e-3 to 1.4e-2, the rounding of bf16 gradients).
TRAIN_LOSS_RTOL = 2e-3
TRAIN_REL_RMS = 3e-2


def train_step(device, cfg):
    """Phase (j): bench's step (make_train_step) for TRAIN_STEPS steps on
    the kernel path and on the plain attention, the loss along the first
    step's gradient, and one update through
    optimizer.create('sgd', ...) and get_updater. Returns (the flash
    kernel's launches over the steps, the step function and its inputs)."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import nd, optimizer
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.transformer import (TRAIN_ATTRS, bench_loss,
                                             loss_and_grads, make_train_step)
    on_card = device.type == 'cuda'
    t0 = time.perf_counter()
    step, masters0, aux, vel0, tokens, labels = make_train_step(
        cfg, MAX_BATCH, device)
    ref_step = make_train_step(cfg, MAX_BATCH, device,
                               attention=ck.flash_attention_ref)[0]
    n_params = sum(m.numel() for m in masters0)
    log('  %d masters (%d f32 parameters) and bench\'s batch %s drawn from '
        'seed 0 in %.1f s' % (len(masters0), n_params, tuple(tokens.shape),
                              time.perf_counter() - t0))

    # the main path: counts are zeroed just before and read just after
    ck.flash_fwd.launches = 0
    ck.flash_fwd.launches_by_body = dict.fromkeys(ck._BODIES, 0)
    masters, vel, losses, grew = masters0, vel0, [], []
    for i in range(TRAIN_STEPS):
        before = ck.flash_fwd.launches
        masters, aux, vel, loss = step(masters, aux, vel, tokens, labels)
        grew.append(ck.flash_fwd.launches - before)
        losses.append(float(loss))
        if i == 0:
            after1 = masters
    launches = ck.flash_fwd.launches
    by_body = dict(ck.flash_fwd.launches_by_body)
    per_step = cfg.n_layers if on_card else 0
    log('  kernel path: losses %s; flash launches a step %s, by body %s'
        % (['%.6f' % x for x in losses], grew, by_body))
    check(grew == [per_step] * TRAIN_STEPS
          and by_body['wgmma'] == launches == per_step * TRAIN_STEPS,
          'flash launches a step %s (by body %s) != %d layers on the wgmma '
          'body' % (grew, by_body, per_step))
    check(all(m.dtype == torch.float32 and bool(torch.isfinite(m).all())
              for m in masters + vel), 'masters or velocities not finite f32')

    ref_masters, ref_vel, ref_losses = masters0, vel0, []
    for i in range(TRAIN_STEPS):
        ref_masters, _, ref_vel, loss = ref_step(ref_masters, aux, ref_vel,
                                                 tokens, labels)
        ref_losses.append(float(loss))
        if i == 0:
            ref_after1 = ref_masters
    check(ck.flash_fwd.launches == launches,
          'the plain-attention step launched the kernel')
    loss_err = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    held = loss_err[:HELD_STEPS]
    upd_err = max(rel_rms(a - m0, b - m0)
                  for a, b, m0 in zip(after1, ref_after1, masters0))
    log('  plain-attention path: losses %s; loss relative error by step %s; '
        'the update of step 1, worst relative RMS error of a master %.3e'
        % (['%.6f' % x for x in ref_losses], ['%.2e' % e for e in loss_err],
           upd_err))
    check(all(np.isfinite(losses)) and max(held) <= TRAIN_LOSS_RTOL,
          'the step\'s losses disagree with the plain-attention step')
    check(upd_err <= TRAIN_REL_RMS,
          'the masters after step 1 disagree with the plain-attention step')
    check(losses[-1] < losses[0], 'the loss did not fall from step 1 to step '
          '%d: %s' % (TRAIN_STEPS, losses))
    del masters, vel, after1, ref_masters, ref_vel, ref_after1

    # The user-facing route on the same gradients: optimizer.create and
    # get_updater over NDArrays of the bf16 weights, with the f32 masters as
    # the optimizer's master state, against the registry op the step calls.
    params = tuple(m.to(torch.bfloat16).requires_grad_() for m in masters0)
    loss0, grads = loss_and_grads(params, tokens, labels)
    along = []
    with torch.no_grad():
        for eps in (1e-4, 1e-3, TRAIN_ATTRS['lr']):
            moved = tuple((m - eps * g.float()).to(torch.bfloat16)
                          for m, g in zip(masters0, grads))
            along.append('%g: %.6f' % (eps, float(bench_loss(moved, tokens,
                                                               labels))))
            del moved
    g2 = sum(float(g.float().square().sum()) for g in grads)
    log('  the loss along the first gradient g (|g|^2 %.4e) from %.6f, by '
        'step size: %s' % (g2, float(loss0), ', '.join(along)))
    update = registry.get('mp_sgd_mom_update').fn
    opt = optimizer.create('sgd', momentum=TRAIN_ATTRS['momentum'],
                           learning_rate=TRAIN_ATTRS['lr'], multi_precision=True)
    updater = optimizer.get_updater(opt)
    ctx = mt.gpu(device.index or 0) if on_card else mt.cpu()
    same = True
    for i, (p, g, v, m) in enumerate(zip(params, grads, vel0, masters0)):
        with torch.no_grad():
            _, want_v, want_m = update(TRAIN_ATTRS, p.detach(), g, v, m)
        w = nd.from_torch(p.detach(), ctx)
        updater.states[i] = (nd.from_torch(m.clone(), ctx),
                             nd.from_torch(v.clone(), ctx))
        updater(i, nd.from_torch(g, ctx), w)
        w32, mom = updater.states[i]
        same = (same and torch.equal(w32.handle, want_m)
                and torch.equal(mom.handle, want_v)
                and torch.equal(w.handle, want_m.to(torch.bfloat16)))
    log('  optimizer.create(\'sgd\', momentum=0.9, learning_rate=0.01, '
        'multi_precision=True) through get_updater on %d NDArrays: masters, '
        'velocities and bf16 weights %s the registry op\'s'
        % (len(params), 'equal, bit for bit, to' if same else 'DIFFER from'))
    check(same, 'the Updater step differs from the registry op\'s')
    del params, grads, updater
    return launches, (step, ref_step, masters0, vel0, tokens, labels)


def train_times(device, cfg, step, ref_step, masters0, vel0, tokens, labels):
    """Phase (e) for the step: step ms (CUDA events, median of TIMED_STEPS
    after a warm-up), tokens/s, where a step's time goes (forward and loss,
    backward, update), and the share of the plain attention's recompute in
    the backward."""
    import torch
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.transformer import TRAIN_ATTRS, bench_loss
    tok = tokens.numel()
    step_ms = device_ms(lambda: step(masters0, (), vel0, tokens, labels),
                        runs=TIMED_STEPS, warmup=1)
    ref_ms = device_ms(lambda: ref_step(masters0, (), vel0, tokens, labels),
                       runs=TIMED_STEPS, warmup=1)
    log('  training step, batch %d x %d: %.3f ms (%.0f tokens/s); with the '
        'plain attention forward %.3f ms (%.0f tokens/s)'
        % (tokens.shape[0], tokens.shape[1], step_ms, tok / step_ms * 1e3,
           ref_ms, tok / ref_ms * 1e3))

    # the step's arithmetic (transformer.bench_loss, its gradients, the
    # update), split by CUDA events
    update = registry.get('mp_sgd_mom_update').fn
    phases = []
    for _ in range(TIMED_STEPS + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda._sleep(2_000_000)
        ev[0].record()
        params = tuple(m.to(torch.bfloat16).requires_grad_() for m in masters0)
        loss = bench_loss(params, tokens, labels)
        ev[1].record()
        grads = torch.autograd.grad(loss, params)
        ev[2].record()
        with torch.no_grad():
            for m, p, g, v in zip(masters0, params, grads, vel0):
                update(TRAIN_ATTRS, p.detach(), g, v, m)
        ev[3].record()
        ev[3].synchronize()
        phases.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        del params, loss, grads
    fwd_ms, bwd_ms, upd_ms = (statistics.median(p[i] for p in phases[1:])
                              for i in range(3))

    # one layer's recompute in the backward (_FlashFunction.backward): the
    # plain attention's forward and its gradient, at the step's shape, in
    # flash_attention's softmax form (the step's) and flash_attention_lse's
    q, k, v = (t.requires_grad_() for t in qkv(
        MAX_BATCH, cfg.seq_len, cfg.seq_len, cfg.n_heads,
        cfg.d_model // cfg.n_heads, 'bfloat16', device, seed=9))
    g = torch.randn_like(q)
    rec_ms, lse_form_ms = (device_ms(lambda: torch.autograd.grad(
        [ref(q, k, v, True)], (q, k, v), [g]), runs=10)
        for ref in (ck.flash_attention_ref,
                    lambda *a: ck.flash_attention_lse_ref(*a)[0]))
    log('  where a step goes (medians of %d): forward and loss %.3f ms, '
        'backward %.3f ms, update (%d mp_sgd_mom_update calls) %.3f ms; one '
        'layer\'s plain-attention recompute and gradient %.3f ms (the lse '
        'form %.3f ms), x %d layers = %.3f ms, %.3f of the step'
        % (TIMED_STEPS, fwd_ms, bwd_ms, len(masters0), upd_ms, rec_ms,
           lse_form_ms, cfg.n_layers, rec_ms * cfg.n_layers,
           rec_ms * cfg.n_layers / step_ms))
    return dict(step_ms=step_ms, ref_step_ms=ref_ms, fwd_ms=fwd_ms,
                bwd_ms=bwd_ms, update_ms=upd_ms, recompute_ms=rec_ms)


# ---------------------------------------------------------------------------
# (k) bench's ResNet-50 step through Gluon, the Symbol graph and the
#     executor; the executor and autograd reaching the row kernels
# ---------------------------------------------------------------------------

# bench's default model: (zoo name, batch, image side, classes)
RESNET = ('resnet50_v1', 32, 224, 1000)
RESNET_STEPS = 5
RESNET_TIMED = 5
# What the run holds of the loss over its steps on the fixed batch: that it
# falls from step 1 to step 2, as the JAX package's own step does at small
# size (tests/test_torch_resnet_step.py holds both packages to it there).
# bench's lr 0.1 with momentum 0.9 then overshoots on the fixed batch: the
# loss rises from step 3 on, in bf16 and in f32 compute alike, and in the
# JAX package's step at small depth-50 sizes too; the losses are printed,
# and the f32 steps' beside them.
# What step 1 in bf16 holds against the same step in f32 compute on the
# card (the same masters, images and labels), with the reasons:
# - the loss (a mean of 32 f32 rows of logsumexp - gold): rtol 2e-2. bf16
#   rounds each activation to 2**-8 relative through 53 convolutions and
#   BatchNorms; the loss, a smooth function of all of them, moves far less;
# - the dense layer's gradients (weight and bias): a relative RMS error of
#   0.15: the bias's is the f32 softmax - onehot of logits that agree to
#   the loss's precision, the weight's that times the pooled features,
#   which carry 53 layers of bf16 rounding (several percent; measured
#   8.6e-2 for the weight and 7.5e-3 for the bias on the H100);
# - the new BN moving statistics: a relative RMS error of 3e-2 (means and
#   variances over 1,568-401,408 values a channel of bf16 activations);
# - the other gradients in training are printed, not held: at bench's
#   initialisation they move by a few percent in f32 alone for a change of
#   one part in a million of the images (printed beside them), so bf16's
#   rounding leaves them far from the f32 ones.
# What step 1 holds with the graph in prediction (BatchNorm on the moving
# statistics, 0 and 1 at bench's initialisation), where the f32 gradients
# move far less for that change of the images (printed): each master's
# bf16 gradient of bench's loss against its f32 one, relative RMS error
# median 0.05 and worst 0.2 over the masters (conv biases included). The
# BatchNorms are then near the identity, the activations grow through the
# residual sums to logits in the thousands, and bench's loss saturates its
# softmax, so bf16's rounding of the logits (2**-8 relative) moves the
# softmax weights of the leading classes and every gradient with them;
# the largest error is the stem convolution's weight, the end of the
# longest backward. Measured on the H100: median 1.47e-2, worst 6.69e-2;
# a gradient lost, or off by a fifth on most masters, fails.
# tests/test_torch_resnet_step.py holds the port's bf16 gradients in
# prediction to the JAX package's on a narrow net.
RESNET_LOSS_RTOL = 2e-2
RESNET_HEAD_REL_RMS = 0.15
RESNET_STAT_REL_RMS = 3e-2
RESNET_PREDICT_REL_RMS = (0.05, 0.2)
# The same net run imperatively and hybridized in f32, on the same
# parameters and batch in training: the same ops in the same order, so the
# logits agree to the f32 rounding of the convolutions' algorithms (cuDNN
# may pick others for two calls): relative RMS 1e-5. The imperative
# forward's gradients through autograd against the runner's (its loss
# through the K3 kernel, the runner's through torch.logsumexp; cuDNN's
# backward sums in another order on each call): relative RMS 1e-3 a master
# (the conv biases, noise, excluded as above).
HYBRID_REL_RMS = 1e-5
IMPERATIVE_GRAD_REL_RMS = 1e-3


def _noise_grad(name):
    """True for the conv biases, whose gradient is rounding noise."""
    return '_conv' in name and name.endswith('_bias')


def resnet_step(device, spec=RESNET):
    """Phase (k1): bench's ResNet-50 step (graph_train.make_train_step) for
    RESNET_STEPS steps; its first step against the same step in f32; the
    hybridized forward against the imperative one and autograd's gradients
    against the runner's. Returns what the timing needs."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon, graph_train, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision
    name, batch, image, classes = spec
    on_card = device.type == 'cuda'
    t0 = time.perf_counter()
    with mt.name.NameManager():
        step, masters0, aux0, vel0, images, labels, prog = \
            graph_train.make_train_step(name, batch, image, classes, device)
    n_params = sum(m.numel() for n, m in zip(prog.arg_names, masters0)
                   if n != 'data')
    log('  %s: %d graph ops, %d masters (%d f32 parameters), %d aux states; '
        'batch %s bf16 and labels from seed 0; built in %.1f s'
        % (name, len(prog.op_nodes), len(masters0) - 1, n_params,
           len(aux0), tuple(images.shape), time.perf_counter() - t0))

    masters, aux, vel, losses = masters0, aux0, vel0, []
    for i in range(RESNET_STEPS):
        masters, aux, vel, loss = step(masters, aux, vel, images, labels)
        losses.append(float(loss))
    finite = all(bool(torch.isfinite(t).all()) for t in masters + aux + vel)
    del masters, aux, vel
    with mt.name.NameManager():
        step32 = graph_train.make_train_step(
            name, batch, image, classes, device, compute_dtype=torch.float32)[0]
    masters, aux, vel, losses32 = masters0, aux0, vel0, []
    for i in range(RESNET_STEPS):
        masters, aux, vel, loss = step32(masters, aux, vel, images.float(),
                                         labels)
        losses32.append(float(loss))
    del masters, aux, vel, step32
    log('  %d steps: losses %s; masters, velocities and aux states %s; the '
        'same steps in f32 compute: losses %s'
        % (RESNET_STEPS, ['%.6f' % x for x in losses],
           'finite' if finite else 'NOT FINITE',
           ['%.6f' % x for x in losses32]))
    check(finite and all(np.isfinite(losses)), 'the step is not finite')
    check(losses[1] < losses[0], 'the loss did not fall from step 1 to step '
          '2: %s' % losses)

    # step 1 against the same step in f32 compute, in training and in
    # prediction, and the f32 gradients' change for images moved by one
    # part in a million
    runner = prog.make_runner()
    gen = torch.Generator(device=images.device).manual_seed(1)
    moved = images.float() * (1 + 1e-6 * torch.randn(
        images.shape, generator=gen, device=images.device))
    loss16, g16, aux16 = graph_train.loss_and_grads(
        runner, prog, masters0, aux0, images, labels, torch.bfloat16)
    loss32, g32, aux32 = graph_train.loss_and_grads(
        runner, prog, masters0, aux0, images.float(), labels, torch.float32)

    def errs(got, want, keep=lambda n: True):
        return {n: rel_rms(a, b) for n, a, b in zip(prog.arg_names, got, want)
                if n != 'data' and keep(n)}
    grad_err = errs(g16, g32)
    head = {n: e for n, e in grad_err.items() if '_dense' in n}
    rest = {n: e for n, e in grad_err.items() if n not in head
            and not _noise_grad(n)}
    worst = max(rest, key=rest.get)
    moved_err = errs(graph_train.loss_and_grads(
        runner, prog, masters0, aux0, moved, labels, torch.float32)[1], g32,
        lambda n: n in rest)
    stat_err = max(rel_rms(a, b) for a, b in zip(aux16, aux32))
    loss_err = abs(float(loss16) - float(loss32)) / abs(float(loss32))
    log('  step 1, bf16 against f32 compute: loss %.6f / %.6f (relative error '
        '%.3e); gradients, relative RMS error: the dense layer\'s %s; the %d '
        'convolution weights and BatchNorm gammas and betas median %.3e, '
        'worst %.3e (%s), not held (f32 with the images moved by 1e-6: '
        'median %.3e, worst %.3e); new BN statistics, worst %.3e'
        % (float(loss16), float(loss32), loss_err,
           ', '.join('%.3e' % e for e in head.values()), len(rest),
           statistics.median(rest.values()), rest[worst], worst,
           statistics.median(moved_err.values()), max(moved_err.values()),
           stat_err))
    check(float(loss16) == losses[0], 'loss_and_grads and the step disagree: '
          '%r, %r' % (float(loss16), losses[0]))
    check(loss_err <= RESNET_LOSS_RTOL, 'step 1\'s loss disagrees with f32')
    check(max(head.values()) <= RESNET_HEAD_REL_RMS,
          'step 1\'s dense gradients disagree with f32')
    check(stat_err <= RESNET_STAT_REL_RMS,
          'step 1\'s new BN statistics disagree with f32')
    del g16, aux16
    pred = {}
    for what, im, dt in (('bf16', images, torch.bfloat16),
                         ('f32', images.float(), torch.float32),
                         ('moved', moved, torch.float32)):
        pred[what] = graph_train.loss_and_grads(
            runner, prog, masters0, aux0, im, labels, dt, is_train=False)
    pred_err = errs(pred['bf16'][1], pred['f32'][1])
    pred_moved = errs(pred['moved'][1], pred['f32'][1])
    worst_p = max(pred_err, key=pred_err.get)
    median_p = statistics.median(pred_err.values())
    log('  step 1 in prediction, bf16 against f32 compute: loss %.6f / %.6f; '
        'the %d masters\' gradients, relative RMS error median %.3e, worst '
        '%.3e (%s), held to %s (f32 with the images moved by 1e-6: median '
        '%.3e, worst %.3e)'
        % (float(pred['bf16'][0]), float(pred['f32'][0]), len(pred_err),
           median_p, pred_err[worst_p], worst_p, RESNET_PREDICT_REL_RMS,
           statistics.median(pred_moved.values()), max(pred_moved.values())))
    check(median_p <= RESNET_PREDICT_REL_RMS[0]
          and pred_err[worst_p] <= RESNET_PREDICT_REL_RMS[1],
          'step 1\'s gradients in prediction disagree with f32')
    del pred, moved

    # the same net through Gluon, imperative and hybridized, in f32
    ctx = mt.gpu(device.index or 0) if on_card else mt.cpu()
    with mt.name.NameManager():
        net = vision.get_model(name, classes=classes)
    net.initialize(ctx=ctx)
    x = nd.from_torch(images.float(), ctx)
    lab = nd.from_torch(labels, ctx)
    with autograd.pause():
        net(x)                              # deferred initialisation
    values = {n: m.cpu().numpy() for n, m in zip(prog.arg_names, masters0)
              if n != 'data'}
    values.update({n: a.cpu().numpy() for n, a in zip(prog.aux_names, aux0)})
    gluon.params_from_numpy(net, values)
    del values
    params = net.collect_params()
    outs = {}
    for mode in ('imperative', 'hybridized'):
        if mode == 'hybridized':
            net.hybridize()
        with autograd.record():
            logits = net(x)
            loss = nd.softmax_cross_entropy(logits, lab) / batch
        loss.backward()
        outs[mode] = (logits.handle.detach(), float(loss.asscalar()),
                      {n: p.grad(ctx).handle.clone()
                       for n, p in params.items() if p.grad_req != 'null'})
    fwd_err = rel_rms(outs['hybridized'][0], outs['imperative'][0])
    imp_grads = outs['imperative'][2]
    ag_err = {n: rel_rms(imp_grads[n], g) for n, g in zip(prog.arg_names, g32)
              if n != 'data' and not _noise_grad(n)}
    worst_ag = max(ag_err, key=ag_err.get)
    log('  Gluon %s in f32, training: hybridized logits against the '
        'imperative forward\'s, relative RMS %.3e (loss %.6f / %.6f; the '
        'runner\'s %.6f); the imperative forward\'s autograd gradients '
        'against the runner\'s, worst relative RMS %.3e (%s)'
        % (name, fwd_err, outs['hybridized'][1], outs['imperative'][1],
           float(loss32), ag_err[worst_ag], worst_ag))
    check(fwd_err <= HYBRID_REL_RMS,
          'the hybridized forward disagrees with the imperative one')
    check(ag_err[worst_ag] <= IMPERATIVE_GRAD_REL_RMS,
          'autograd\'s gradients disagree with the runner\'s')
    del net, params, outs, imp_grads, g32, aux32, x
    return dict(step=step, masters=masters0, aux=aux0, vel=vel0,
                images=images, labels=labels, prog=prog, runner=runner,
                losses=losses)


def resnet_times(device, step, masters, aux, vel, images, labels, prog,
                 runner, losses):
    """Phase (k1)'s times: step ms and images/s (CUDA events, median of
    RESNET_TIMED after a warm-up), the host's wall time of a step, the split
    into forward and loss, backward and update, and the profiler's top
    device kernels and idle share over 3 steps."""
    import torch
    from mxnet_tpu_torch import graph_train
    from mxnet_tpu_torch.ops.registry import get as get_op
    batch = images.shape[0]

    def one():
        return step(masters, aux, vel, images, labels)
    step_ms = device_ms(one, runs=RESNET_TIMED, warmup=1)
    torch.cuda.synchronize()
    walls = []
    for _ in range(RESNET_TIMED):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    log('  step, batch %d x 3 x %d x %d: %.3f ms by CUDA events (%.1f '
        'images/s); host wall time %.3f ms (%.1f images/s)'
        % (batch, images.shape[2], images.shape[3], step_ms,
           batch / step_ms * 1e3, wall_ms, batch / wall_ms * 1e3))

    update = get_op('mp_sgd_mom_update').fn
    data_idx = prog.arg_names.index('data')
    phases = []
    for _ in range(RESNET_TIMED + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda._sleep(2_000_000)
        ev[0].record()
        args = [images if i == data_idx
                else m.to(torch.bfloat16).requires_grad_()
                for i, m in enumerate(masters)]
        with torch.enable_grad():
            outs, _ = runner(tuple(args), tuple(a.to(torch.bfloat16)
                                                for a in aux), 0, True)
            logits = outs[0].float()
            loss = (torch.logsumexp(logits, -1) - logits.gather(
                -1, labels.long()[:, None])[:, 0]).mean()
        ev[1].record()
        wrt = [a for i, a in enumerate(args) if i != data_idx]
        grads = torch.autograd.grad(loss, wrt)
        ev[2].record()
        with torch.no_grad():
            for m, g, v in zip([m for i, m in enumerate(masters)
                                if i != data_idx], grads,
                               [v for i, v in enumerate(vel) if i != data_idx]):
                update(graph_train.TRAIN_ATTRS, m.to(torch.bfloat16), g, v, m)
        ev[3].record()
        ev[3].synchronize()
        phases.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        del args, outs, logits, loss, grads, wrt
    fwd_ms, bwd_ms, upd_ms = (statistics.median(p[i] for p in phases[1:])
                              for i in range(3))
    log('  where a step goes (medians of %d): forward and loss %.3f ms, '
        'backward %.3f ms, update (%d mp_sgd_mom_update calls) %.3f ms'
        % (RESNET_TIMED, fwd_ms, bwd_ms, len(masters) - 1, upd_ms))
    profile_steps(one, set(prog.scope_names))
    return dict(step_ms=step_ms, wall_ms=wall_ms, fwd_ms=fwd_ms,
                bwd_ms=bwd_ms, update_ms=upd_ms)


def profile_steps(one, ranges, n=3):
    """Device time by kernel over ``n`` calls of ``one``, the device's idle
    share of the span from the first kernel's start to the last one's end,
    and the host time the calls took. ``ranges``: the names of the
    record_function ranges that ``one`` opens, which the profiler also
    puts on the device's timeline, over the kernels they hold (not
    counted)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    one()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            one()
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and e.name not in ranges
               and not getattr(e, 'is_user_annotation', False)]
    if not kernels:
        log('  the profiler recorded no device activity: not measured')
        return
    by_name, count = {}, {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        count[e.name] = count.get(e.name, 0) + 1
    busy = sum(by_name.values())
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    log('  torch.profiler over %d steps: %d kernels a step, %.3f ms busy a '
        'step, idle share %.4f of the %.3f ms span; %.3f ms of host time a '
        'step under the profiler'
        % (n, len(kernels) // n, busy / n / 1e3, 1 - busy / span,
           span / n / 1e3, host_ms))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log('    %6.2f%%  %8.3f ms/step  %5d/step  %s'
            % (100 * us / busy, us / n / 1e3, count[name] // n, name[:100]))


# Phase (k2)'s symbol at bench's transformer widths: LayerNorm over x
# [8192, 1024] bf16, FullyConnected to V = 16384 without a bias, the logits
# cast to f32, softmax_cross_entropy against labels. Tolerances against the
# plain versions composed with torch autograd on the same tensors: the loss
# (a sum of 8,192 f32 rows of about 10) to 1e-3 relative: the LayerNorm
# kernel's bf16 output may differ from the plain version's by one bf16 ulp
# in an element (phase (g)), which moves each logit it feeds by up to
# 2**-9 of that element's term; each gradient (bf16) to a relative RMS
# error of 1e-2: LayerNorm's
# backward recomputes through its plain version on both sides, the
# cross-entropy's is (softmax - onehot) * g in f32 against autograd's of
# log_softmax, so each bf16 gradient element may round to a neighbouring
# value (2**-8 relative, 2**-7 near powers of two).
EXEC_LOSS_RTOL = 1e-3
EXEC_GRAD_REL_RMS = 1e-2


def executor_kernels(device, cfg):
    """Phase (k2): a Symbol LayerNorm -> FullyConnected -> Cast ->
    softmax_cross_entropy simple_bind'ed on the card, forward(is_train=True)
    and backward, with K4's and K3's launch counts. Returns {wrapper:
    launches}."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    sym = mt.sym
    N, D, V = MAX_BATCH * cfg.seq_len, cfg.d_model, cfg.vocab
    ctx = mt.gpu(device.index or 0) if device.type == 'cuda' else mt.cpu()
    x = sym.var('x')
    logits = sym.Cast(sym.FullyConnected(sym.LayerNorm(x, name='ln'),
                                         num_hidden=V, no_bias=True,
                                         name='head'), dtype='float32')
    loss = sym.softmax_cross_entropy(logits, sym.var('label'))
    reqs = {'x': 'write', 'ln_gamma': 'write', 'ln_beta': 'write',
            'head_weight': 'write', 'label': 'null'}
    ex = loss.simple_bind(ctx, grad_req=reqs,
                          type_dict={'x': 'bfloat16', 'label': 'int32'},
                          x=(N, D), label=(N,))
    g = torch.Generator(device=device).manual_seed(21)
    vals = {'x': torch.randn(N, D, generator=g, device=device),
            'ln_gamma': 1 + 0.1 * torch.randn(D, generator=g, device=device),
            'ln_beta': 0.1 * torch.randn(D, generator=g, device=device),
            'head_weight': torch.randn(V, D, generator=g, device=device)
            / math.sqrt(D)}
    vals = {n: v.to(torch.bfloat16) for n, v in vals.items()}
    vals['label'] = torch.randint(0, V, (N,), generator=g, device=device,
                                  dtype=torch.int32)
    for n, v in vals.items():
        check(ex.arg_dict[n].handle.dtype == v.dtype,
              'simple_bind gave %s %s' % (n, ex.arg_dict[n].handle.dtype))
        ex.arg_dict[n]._data = v

    counters = (ck.layernorm_fwd, ck.rmsnorm_fwd, ck.softmax_fwd,
                ck.softmax_xent_fwd)
    # the main path: counts are zeroed just before and read just after
    for fwd in counters:
        fwd.launches = 0
    out = ex.forward(is_train=True)[0]
    ex.backward()
    out.wait_to_read()
    launches = {fwd.__name__: fwd.launches for fwd in counters}
    want = {'layernorm_fwd': 1, 'rmsnorm_fwd': 0, 'softmax_fwd': 0,
            'softmax_xent_fwd': 1}
    if device.type != 'cuda':
        want = dict.fromkeys(want, 0)
    log('  simple_bind(x [%d, %d] bf16 -> LayerNorm -> FullyConnected to %d '
        '-> f32 -> softmax_cross_entropy), forward(is_train=True) and '
        'backward: launches %s' % (N, D, V, launches))
    check(launches == want, 'executor launches %s != %s' % (launches, want))

    leaves = {n: vals[n].clone().requires_grad_() for n in reqs
              if reqs[n] != 'null'}
    h = ck.layernorm_ref(leaves['x'], leaves['ln_gamma'], leaves['ln_beta'])
    z = (h @ leaves['head_weight'].t()).float()
    ref = ck.softmax_xent_ref(z, vals['label']).sum()
    grads = torch.autograd.grad(ref, list(leaves.values()))
    ref_loss = float(ref.detach())
    loss_err = abs(float(out.asscalar()) - ref_loss) / abs(ref_loss)
    errs = {n: rel_rms(ex.grad_dict[n].handle, gr)
            for n, gr in zip(leaves, grads)}
    log('  loss %.4f against the plain versions\' %.4f (relative error '
        '%.3e); gradients, relative RMS error %s'
        % (float(out.asscalar()), ref_loss, loss_err,
           ', '.join('%s %.3e' % kv for kv in errs.items())))
    check(loss_err <= EXEC_LOSS_RTOL, 'the executor\'s loss disagrees')
    check(max(errs.values()) <= EXEC_GRAD_REL_RMS,
          'the executor\'s gradients disagree')
    return launches


# Phase (k3)'s tolerances: each gradient against the plain version's
# autograd gradient on the same tensors and head gradients. LayerNorm's
# backward recomputes through its plain version: equal up to the order of
# the sums, relative RMS 1e-3 (bf16 results); softmax's reads the kernel's
# y, one bf16 rounding from the plain y, relative RMS 1e-2; the
# cross-entropy's (f32 logits) relative RMS 1e-5.
AUTOGRAD_REL_RMS = {'layernorm': 1e-3, 'softmax': 1e-2, 'softmax_xent': 1e-5}


def autograd_kernels(device, cfg):
    """Phase (k3): nd.LayerNorm on [8, 1024, 1024] bf16, nd.softmax on one
    layer's scores [8, 8, 1024, 1024] bf16 and nd.softmax_cross_entropy on
    f32 logits [8192, 16384] under autograd.record(), then backward, with
    K3-K5's launch counts. Returns {wrapper: launches}."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    ctx = mt.gpu(device.index or 0) if device.type == 'cuda' else mt.cpu()
    shapes = model_shapes(cfg)
    x, gamma, beta = row_inputs('layernorm', shapes['layernorm'], 'bfloat16',
                                device, seed=31)
    scores, = row_inputs('softmax', shapes['softmax'], 'bfloat16', device,
                         seed=32)
    N, V = MAX_BATCH * cfg.seq_len, cfg.vocab
    g = torch.Generator(device=device).manual_seed(33)
    logits = 3 * torch.randn(N, V, generator=g, device=device)
    labels = torch.randint(0, V, (N,), generator=g, device=device,
                           dtype=torch.int32)
    heads = [torch.randn(x.shape, generator=g, device=device).to(x.dtype),
             torch.randn(scores.shape, generator=g,
                         device=device).to(scores.dtype)]
    arrays = [nd.from_torch(t.clone(), ctx)
              for t in (x, gamma, beta, scores, logits)]
    for a in arrays:
        a.attach_grad()
    xa, ga, ba, sa, la = arrays

    counters = (ck.layernorm_fwd, ck.rmsnorm_fwd, ck.softmax_fwd,
                ck.softmax_xent_fwd)
    # the main path: counts are zeroed just before and read just after
    for fwd in counters:
        fwd.launches = 0
    with autograd.record():
        h = nd.LayerNorm(xa, ga, ba, eps=1e-5)
        p = nd.softmax(sa)
        loss = nd.softmax_cross_entropy(la, nd.from_torch(labels, ctx))
    autograd.backward([h, p, loss], [nd.from_torch(heads[0], ctx),
                                     nd.from_torch(heads[1], ctx), None])
    loss.wait_to_read()
    launches = {fwd.__name__: fwd.launches for fwd in counters}
    want = {'layernorm_fwd': 1, 'rmsnorm_fwd': 0, 'softmax_fwd': 1,
            'softmax_xent_fwd': 1}
    if device.type != 'cuda':
        want = dict.fromkeys(want, 0)
    log('  autograd.record(): nd.LayerNorm %s, nd.softmax %s, '
        'nd.softmax_cross_entropy %s, then backward: launches %s'
        % (tuple(x.shape), tuple(scores.shape), tuple(logits.shape), launches))
    check(launches == want, 'autograd launches %s != %s' % (launches, want))

    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta, scores,
                                                    logits)]
    want_h = ck.layernorm_ref(*leaves[:3], 1e-5)
    want_p = ck.softmax_ref(leaves[3])
    want_l = ck.softmax_xent_ref(leaves[4], labels).sum()
    ref = torch.autograd.grad([want_h, want_p, want_l], leaves,
                              [heads[0], heads[1], None])
    errs = {}
    for kernel, idx in (('layernorm', (0, 1, 2)), ('softmax', (3,)),
                        ('softmax_xent', (4,))):
        errs[kernel] = max(rel_rms(arrays[i].grad.handle, ref[i])
                           for i in idx)
    log('  gradients against the plain versions\', worst relative RMS error: '
        '%s' % ', '.join('%s %.3e' % kv for kv in errs.items()))
    for kernel, e in errs.items():
        check(e <= AUTOGRAD_REL_RMS[kernel],
              'autograd\'s %s gradient disagrees' % kernel)
    return launches


# ---------------------------------------------------------------------------
# (e) times of the row kernels
# ---------------------------------------------------------------------------

# operations per element of each row kernel's arithmetic (f32, outside the
# tensor cores): layernorm add; sub, mul, add; sub, mul, mul, add -> 8;
# rmsnorm mul, add; mul, mul -> 4; softmax max; sub, exp, add; sub, exp,
# div -> 7; xent max; sub, exp, add -> 4.
ROW_OPS_PER_ELEMENT = {'layernorm': 8, 'rmsnorm': 4, 'softmax': 7,
                       'softmax_xent': 4}


def row_bound_ms(kernel, args, out):
    """(bound ms, 'bytes' or 'operations', bytes, ops): each input read once
    and the output written once over the memory rate, against the f32
    operations over the f32 rate."""
    nbytes = sum(a.numel() * a.element_size() for a in args) \
        + out.numel() * out.element_size()
    ops = ROW_OPS_PER_ELEMENT[kernel] * args[0].numel()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations',
            nbytes, ops)


def library_call(kernel, args):
    """One PyTorch call computing the kernel's function, timed as a
    yardstick only (the port never calls it), or None."""
    import torch
    import torch.nn.functional as F
    if kernel == 'layernorm':
        x, g, b = args
        g, b = g.to(x.dtype), b.to(x.dtype)
        return lambda: F.layer_norm(x, (x.shape[-1],), g, b, 1e-5)
    if kernel == 'rmsnorm':
        if not hasattr(F, 'rms_norm'):
            return None
        x, g = args
        g = g.to(x.dtype)
        return lambda: F.rms_norm(x, (x.shape[-1],), g, 1e-6)
    if kernel == 'softmax':
        return lambda: torch.softmax(args[0], -1)
    logits, labels = args
    labels = labels.long()
    return lambda: F.cross_entropy(logits, labels, reduction='none')


def row_body_call(kernel, body, args):
    """(a call of the softmax or rmsnorm C entry on ``args`` with ``body``,
    its output): how (e) times one body beside another. The wrapper itself
    takes no body argument."""
    import torch
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    lib = ck._row_lib()
    x = args[0]
    out = torch.empty_like(x)
    N, D = ck._rows(x, kernel)
    b, dt = ck._ROW_BODIES.index(body), ck._ROW_DTYPES[x.dtype]
    stream = ck._stream(x.device)
    if kernel == 'softmax':
        def launch():
            return lib.mxtt_softmax(b, dt, x.data_ptr(), out.data_ptr(), N, D, stream)
    else:
        g = args[1]

        def launch():
            return lib.mxtt_rmsnorm(b, dt, x.data_ptr(), g.data_ptr(),
                                    ck._ROW_DTYPES[g.dtype], out.data_ptr(), N, D,
                                    1e-6, stream)

    def call():
        err = launch()
        check(err == 0, '%s %s body launch failed (%d)' % (kernel, body, err))
    return call, out


# The bodies of softmax and RMSNorm timed in turns, block first and last.
BODY_TURNS = ('block', 'ring', 'ring', 'block')


def body_times(kernel, args, ref_out, flush):
    """{body: mean of its device times in BODY_TURNS} of ``kernel`` on
    ``args`` through the C entry, each body's output held to the plain
    version."""
    import torch
    calls = {b: row_body_call(kernel, b, args) for b in set(BODY_TURNS)}
    got = {b: [] for b in calls}
    for b in BODY_TURNS:
        got[b].append(device_ms(calls[b][0], flush=flush))
    atol, rtol = ROW_TOL[str(args[0].dtype).replace('torch.', '')]
    for b, (_, out) in calls.items():
        check(excess(out, ref_out, atol, rtol) <= atol and bool(torch.isfinite(out).all()),
              '%s %s body disagrees with its plain version in (e)' % (kernel, b))
    return {b: sum(t) / len(t) for b, t in got.items()}, got


def row_times(device, cfg):
    """Each row kernel at its shape on the model's path (bf16 activations
    and scores, f32 logits), from a cold L2: its time, its plain version's,
    one PyTorch call's and its bound. For softmax and RMSNorm, also each
    body's time in turns through the C entry."""
    import torch
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    shapes = model_shapes(cfg)
    out = {}
    for kernel in ROW_KERNELS:
        dtype = 'float32' if kernel == 'softmax_xent' else 'bfloat16'
        args = row_inputs(kernel, shapes[kernel], dtype, device, seed=21)
        if kernel == 'softmax_xent':
            args[1].clamp_(0, cfg.vocab - 1)         # bench's labels are in range
        fwd, ref, _ = row_fns(kernel)
        kernel_ms = device_ms(lambda: fwd(*args), flush=flush)
        plain_ms = device_ms(lambda: ref(*args), flush=flush, runs=10)
        lib = library_call(kernel, args)
        library_ms = device_ms(lib, flush=flush) if lib is not None else None
        bound_ms, bound_by, nbytes, ops = row_bound_ms(kernel, args, fwd(*args))
        body, extra = {}, ''
        if kernel in REGISTER_BODY:
            pick = ck._layernorm_body if kernel == 'layernorm' else ck._row_body
            body = {'body': REGISTER_BODY[kernel]}
            check(pick(args[0]) == body['body'], '%s body' % kernel)
            extra = ' (%s body)' % body['body']
        log('  %-12s %-22s %-8s kernel %.4f ms%s, plain %.4f ms, library %s '
            'ms, bound %.4f ms (%s: %.1f MB, %.2f GFLOP), bound / kernel %.3f'
            % (kernel, tuple(shapes[kernel]), dtype, kernel_ms, extra, plain_ms,
               'n/a' if library_ms is None else '%.4f' % library_ms, bound_ms,
               bound_by, nbytes / 1e6, ops / 1e9, bound_ms / kernel_ms))
        if body.get('body') == 'ring':
            mean, turns = body_times(kernel, args, ref(*args), flush)
            lib2 = device_ms(lib, flush=flush) if lib is not None else None
            # a device copy of x: the bytes without the arithmetic
            dst = torch.empty_like(args[0])
            copy_ms = device_ms(lambda: dst.copy_(args[0]), flush=flush)
            log('    bodies in turns %s: %s; library again %s ms; a copy of x '
                '%.4f ms; bound / ring body %.3f, ring / block %.3f'
                % ('-'.join(BODY_TURNS),
                   ', '.join('%s %s ms' % (b, '/'.join('%.4f' % t for t in turns[b]))
                             for b in ('block', 'ring')),
                   'n/a' if lib2 is None else '%.4f' % lib2, copy_ms,
                   bound_ms / mean['ring'], mean['ring'] / mean['block']))
            del dst
            # the same with an L2 left clean (the flush read, not written):
            # what the write-back of the flush's dirty lines costs the call
            def clean():
                flush.sum(dtype=torch.int64)
            ring_call = row_body_call(kernel, 'ring', args)[0]
            log('    with a clean L2 (flush read, not written): ring body %.4f '
                'ms, library %s ms'
                % (device_ms(ring_call, flush=clean),
                   'n/a' if lib is None else '%.4f' % device_ms(lib, flush=clean)))
            body['block_ms'] = mean['block']
        out[kernel] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by, **body)
        del args
    del flush
    return out


# ---------------------------------------------------------------------------
# (e) times
# ---------------------------------------------------------------------------

def device_ms(fn, runs=TIMED_RUNS, warmup=3, flush=None):
    """Median device time of ``fn()`` in ms over ``runs`` CUDA-event pairs.
    A sleep kernel ahead of each start event lets the host enqueue the
    launch before the device reaches it, so host overhead is not timed.
    ``flush``: a buffer larger than the L2 cache, overwritten before each
    start event, so that ``fn`` finds its inputs in device memory (and the
    L2 full of dirty lines, as a kernel that wrote its output leaves it), or
    a function called there instead."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        if callable(flush):
            flush()
        elif flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flash_bound_ms(B, T, H, D):
    """Least time for bf16 causal attention with Tq = Tk = T: q, k, v read
    and out (bf16), lse (f32) written once, vs 4*D FLOPs for each visible
    (query, key) pair (q.k and p.v), T*(T+1)/2 of them per head."""
    nbytes = 4 * B * T * H * D * 2 + B * H * T * 4
    flops = 4 * D * (T * (T + 1) // 2) * B * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else 'operations',
            nbytes, flops)


def times(device, model, ref, cfg):
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.transformer import HEAD_DIM
    B, T, H, D = MAX_BATCH, cfg.seq_len, cfg.n_heads, HEAD_DIM
    q, k, v = qkv(B, T, T, H, D, 'bfloat16', device, seed=5)
    check(ck._BODIES[ck._variant(q, k, v)] == 'wgmma', 'served shape body')
    kernel_ms = device_ms(lambda: ck.flash_fwd(q, k, v, True))
    plain_ms = device_ms(lambda: ck.flash_attention_lse_ref(q, k, v, True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    bound_ms, bound_by, nbytes, flops = flash_bound_ms(B, T, H, D)
    log('  flash at [%d, %d, %d, %d] bf16 causal: wgmma body %.4f ms, plain '
        '%.4f ms, SDPA %.4f ms, bound %.4f ms (%s: %.1f MB, %.2f GFLOP), '
        'bound / kernel %.3f'
        % (B, T, H, D, kernel_ms, plain_ms, library_ms, bound_ms,
           bound_by, nbytes / 1e6, flops / 1e9, bound_ms / kernel_ms))
    nc_ms = device_ms(lambda: ck.flash_fwd(q, k, v, False))
    nc_lib = device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=False))
    log('  flash non-causal at the same shape: wgmma body %.4f ms, SDPA %.4f ms'
        % (nc_ms, nc_lib))
    # the steady state of the tile loop, where a work item has 128 tiles
    ql, kl, vl = (t.transpose(1, 2) for t in qkv(1, 16384, 16384, H, D,
                                                  'bfloat16', device, seed=6))
    for causal in (True, False):
        pairs = 16384 * 16385 // 2 if causal else 16384 ** 2
        gflop = 4 * D * pairs * H / 1e9
        k_ms = device_ms(lambda: ck.flash_fwd(*(t.transpose(1, 2) for t in
                                                (ql, kl, vl)), causal), runs=10)
        l_ms = device_ms(lambda: F.scaled_dot_product_attention(
            ql, kl, vl, is_causal=causal), runs=10)
        log('  flash at [1, 16384, %d, %d] bf16 causal=%d: wgmma body %.4f ms '
            '(%.0f TFLOP/s), SDPA %.4f ms (%.0f TFLOP/s)'
            % (H, D, causal, k_ms, gflop / k_ms, l_ms, gflop / l_ms))
    del ql, kl, vl
    log('  host time of one flash_fwd call (enqueue, 200 back to back, the '
        'card busy): wgmma body %.1f us (three tensor maps encoded)'
        % host_us(lambda: ck.flash_fwd(q, k, v, True)))

    tokens = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab, (MAX_BATCH, cfg.seq_len)).astype(np.int32)).to(device)
    with torch.inference_mode():
        fwd_ms = device_ms(lambda: model(tokens), runs=20)
        ref_fwd_ms = device_ms(lambda: ref(tokens), runs=20)
    tok = MAX_BATCH * cfg.seq_len
    log('  full-width forward, batch %d x %d: %.3f ms (%.0f tokens/s); with the '
        'plain attention %.3f ms (%.0f tokens/s)'
        % (MAX_BATCH, cfg.seq_len, fwd_ms, tok / fwd_ms * 1e3, ref_fwd_ms,
           tok / ref_fwd_ms * 1e3))
    return dict(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, fwd_ms=fwd_ms,
                ref_fwd_ms=ref_fwd_ms)


def host_us(fn, n=200):
    """Host time of one ``fn()`` call in us: ``n`` calls enqueued behind a
    sleep kernel that keeps the card busy, so that no call waits on it."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / n * 1e6


def profile_forward(device, model, cfg, n=3):
    """Device time by kernel over ``n`` forwards, and the device's idle share
    of the span from the first kernel's start to the last one's end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab, (MAX_BATCH, cfg.seq_len)).astype(np.int32)).to(device)
    with torch.inference_mode():
        model(tokens)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                model(tokens)
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log('  the profiler recorded no device activity: not measured')
        return
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    log('  %d kernels, %.3f ms busy per forward, idle share %.4f of the %.3f ms '
        'span' % (len(kernels), busy / n / 1e3, 1 - busy / span, span / n / 1e3))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log('    %6.2f%%  %8.3f ms/forward  %s' % (100 * us / busy, us / n / 1e3,
                                                 name[:110]))


# ---------------------------------------------------------------------------
# (l) Module.fit, the Gluon loop and the kernels through Module
# ---------------------------------------------------------------------------

FIT_IMAGES = 256        # train_imagenet's recipe: 8 batches of 32, one epoch
FIT_OPT = {'learning_rate': 0.1, 'momentum': 0.9, 'wd': 1e-4}
FIT_SPEEDOMETER = 4     # Speedometer(batch, 4): a log line every 4 batches
# (l1) and (l3) hold their first batch against graph_train's f32 step from
# the same masters, aux states, images and labels (the same graph, ops and
# update in f32, with the head's gradient computed by SoftmaxOutput, or
# log_softmax and pick, instead of autograd of logsumexp - gold):
# - the loss, rtol 1e-4: the same forward, the loss read from the outputs
#   (-log of the softmax at the label, or the Gluon loss) instead of
#   logsumexp - gold, one f32 rounding apart a row;
# - the update (every master's new - old, concatenated), relative RMS
#   error 1e-4. What sets it is printed beside it: the same f32 step run
#   twice differs by about 1e-5 (measured 1.02e-5 on the H100; cuDNN's
#   backward sums in an order of its own on each call, and the BatchNorms'
#   ill-conditioned backward at this initialisation carries that far), and
#   the batch through Module by as much (1.04e-5, Gluon 1.03e-5): the bound
#   is ten times that floor. Images moved by one part in 1e6 move the
#   update by 3.3e-2, so a wrong image, label or gradient scale fails.
FIT_LOSS_RTOL = 1e-4
FIT_UPDATE_REL_RMS = 1e-4
# (l2): each batch's loss against the plain versions on the same
# parameters and batch, as (k2) holds it
MODULE_LOSS_RTOL = EXEC_LOSS_RTOL
MODULE_BATCHES = 3


def _zoo_symbol(name, classes, data_shape):
    """The zoo net ``name`` hybridized and traced by ``_get_graph`` (as
    graph_train.build_graph does) under SoftmaxOutput(name='softmax')."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import graph_train
    from mxnet_tpu_torch.gluon.model_zoo import vision
    with mt.name.NameManager():
        net = vision.get_model(name, classes=classes)
    net.hybridize()
    _, out = net._get_graph(graph_train._placeholder(data_shape))
    return mt.sym.SoftmaxOutput(out, name='softmax')


def _xavier():
    import mxnet_tpu_torch as mt
    return mt.init.Xavier(rnd_type='gaussian', factor_type='in', magnitude=2)


def _f32_step(spec, device, masters, aux, images, labels):
    """graph_train's f32 step from the given masters and aux states (by
    name): (loss, {name: update}, names), twice over and with the images
    moved by one part in 1e6, for the bound's reasons."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import graph_train
    name, batch, image, classes = spec
    with mt.name.NameManager():
        step, m0, a0, v0, _, _, prog = graph_train.make_train_step(
            name, batch, image, classes, device, compute_dtype=torch.float32)
    m0 = tuple(images if n == 'data' else masters[n].to(device)
               for n in prog.arg_names)
    a0 = tuple(aux[n].to(device) for n in prog.aux_names)
    gen = torch.Generator(device=device).manual_seed(2)
    moved = images * (1 + 1e-6 * torch.randn(images.shape, generator=gen,
                                             device=device))
    runs = {}
    for what, im in (('step', images), ('again', images), ('moved', moved)):
        new, _, _, loss = step(m0, a0, v0, im, labels)
        runs[what] = (float(loss), torch.cat(
            [(b - a).flatten() for n, a, b in zip(prog.arg_names, m0, new)
             if n != 'data']))
    names = [n for n in prog.arg_names if n != 'data']
    walls = []
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        step(m0, a0, v0, images, labels)
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    runs['step_wall_ms'] = statistics.median(walls)
    return runs, names


def _sync(device):
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def fit_split(mod, data, device, n=4):
    """Where a fit batch's host wall time goes: the forward (with the
    batch's copy to the card), the backward, the update and the acc
    metric, each waited for on the card, medians over batches 2-n."""
    import mxnet_tpu_torch as mt
    metric = mt.metric.create(['acc'])
    data.reset()
    parts = []
    for _, batch in zip(range(n), data):
        t = [time.perf_counter()]
        for call in (lambda: mod.forward(batch, is_train=True), mod.backward,
                     mod.update,
                     lambda: mod.update_metric(metric, batch.label)):
            call()
            _sync(device)
            t.append(time.perf_counter())
        parts.append(np.diff(t) * 1e3)
    return [statistics.median(p[i] for p in parts[1:]) for i in range(4)]


def _concat_update(names, before, after):
    import torch
    return torch.cat([(after[n].float() - before[n].float()).flatten()
                      for n in names])


def module_fit(device, spec=RESNET, n_images=FIT_IMAGES, ckpt=None):
    """Phase (l1): train_imagenet's recipe through Module.fit on bench's
    model at full width; batch 1 against graph_train's f32 step; the acc
    metric against the outputs; save_checkpoint (at the prefix ``ckpt``,
    epoch 0 before the fit and epoch 1 after it, kept for phase (n); else
    in a temporary directory), Module.load and predict. Returns what phase
    (l3) needs."""
    import logging
    import torch
    import mxnet_tpu_torch as mt
    name, batch, image, classes = spec
    on_card = device.type == 'cuda'
    ctx = mt.gpu(device.index or 0) if on_card else mt.cpu()
    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    X = rng.standard_normal((n_images, 3, image, image)).astype(np.float32)
    y = rng.randint(0, classes, n_images).astype(np.int32)
    train = mt.io.NDArrayIter(X, y, batch_size=batch)
    sym = _zoo_symbol(name, classes, (batch, 3, image, image))
    # the default context: the card
    mod = mt.mod.Module(sym) if on_card else mt.mod.Module(sym, context=ctx)
    # bound and initialised before fit, so that the masters batch 1 starts
    # from can be read; fit's own bind and init_params then keep them
    mod.bind(train.provide_data, train.provide_label)
    mt.random.seed(0)
    mod.init_params(_xavier())
    args, aux = mod.get_params()
    masters0 = {n: a.handle.detach().clone() for n, a in args.items()}
    aux0 = {n: a.handle.detach().clone() for n, a in aux.items()}
    group = mod._exec_group
    bound = [a for e in group.execs for a in
             list(e.arg_dict.values()) + list(e.aux_dict.values())
             + [g for g in e.grad_dict.values() if g is not None]]
    check(all(a.handle.device.type == device.type for a in bound),
          'an array bound by Module is not on %s' % device.type)
    log('  Module(%s under SoftmaxOutput) on %s: %d bound arrays, all on %s; '
        '%d images %s f32 from seed 0; set up in %.1f s'
        % (name, mod._context, len(bound), device.type, n_images,
           (3, image, image), time.perf_counter() - t0))

    seen = {'loss': [], 'acc': [], 'ev': [], 'wall': [], 'speed': [],
            'outputs_finite': []}

    class Speeds(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if 'Speed:' in msg:
                seen['speed'].append(float(msg.split('Speed: ')[1].split()[0]))
                log('   ', msg)
    handler = Speeds()
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    prev = {'metric': (0, 0)}

    def per_batch(param):
        # batch i's loss and hits from its outputs, on the device; the acc
        # metric's increment against them; the masters after batch 1
        data_batch = param.locals['data_batch']
        probs = mod.get_outputs()[0].handle
        lab = data_batch.label[0].handle.to(probs.device).long()
        picked = probs.gather(1, lab[:, None])[:, 0]
        seen['loss'].append(float(-picked.log().mean()))
        seen['outputs_finite'].append(bool(torch.isfinite(probs).all()))
        hits = int((probs.argmax(1) == lab).sum())
        acc = param.eval_metric.get_metric(0)
        cur = (acc.sum_metric, acc.num_inst)
        if cur[1] < prev['metric'][1]:          # Speedometer reset it
            prev['metric'] = (0, 0)
        seen['acc'].append((int(cur[0] - prev['metric'][0]), hits,
                            int(cur[1] - prev['metric'][1])))
        prev['metric'] = cur
        if param.nbatch == 0:
            a, _ = mod.get_params()
            seen['after1'] = {n: v.handle.detach().clone() for n, v in a.items()}
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            seen['ev'].append(ev)
        seen['wall'].append(time.perf_counter())

    if ckpt:
        # the initial parameters too: phase (n1) serves both checkpoints
        mod.save_checkpoint(ckpt, 0)
    t0 = time.perf_counter()
    mod.fit(train, num_epoch=1, optimizer='sgd', optimizer_params=FIT_OPT,
            initializer=_xavier(), eval_metric=['acc'], kvstore='device',
            batch_end_callback=[per_batch,
                                mt.callback.Speedometer(batch, FIT_SPEEDOMETER)])
    if on_card:
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    root.removeHandler(handler)
    root.setLevel(level)
    n_batches = n_images // batch
    check(len(seen['loss']) == n_batches, 'fit ran %d batches, not %d'
          % (len(seen['loss']), n_batches))
    log('  fit, one epoch of %d batches in %.2f s: losses %s'
        % (n_batches, fit_s, ['%.6f' % x for x in seen['loss']]))
    # a batch's outputs are finite probabilities; its loss -log(p) is inf
    # where a sample's f32 softmax probability underflows to 0 (a logit gap
    # above about 104, which the recipe's diverging batches reach), and NaN
    # only where the fit broke
    check(all(seen['outputs_finite']) and not np.isnan(seen['loss']).any(),
          'a batch\'s outputs are not finite')
    bad = [(i, a) for i, a in enumerate(seen['acc'])
           if a[0] != a[1] or a[2] != batch]
    log('  acc metric: hits a batch %s, each as the outputs give them'
        % [a[0] for a in seen['acc']])
    check(not bad, 'the acc metric disagrees with the outputs: %s' % bad)
    walls = np.diff(seen['wall']) * 1e3
    batch_ms = None
    if on_card:
        evs = seen['ev']
        batch_ms = statistics.median(evs[i].elapsed_time(evs[i + 1])
                                     for i in range(len(evs) - 1))
    wall_ms = statistics.median(walls)
    log('  a fit batch (medians over batches 2-%d, each with the acc '
        'metric\'s and this check\'s reads of the outputs): %s by CUDA '
        'events, %.3f ms of host wall time (%.1f images/s); Speedometer: %s '
        'samples/s'
        % (n_batches, '%.3f ms' % batch_ms if batch_ms else 'not measured',
           wall_ms, batch / wall_ms * 1e3, seen['speed']))

    # batch 1 against graph_train's f32 step from the same state
    images = torch.from_numpy(X[:batch]).to(device)
    labels = torch.from_numpy(y[:batch]).to(device)
    runs, names = _f32_step(spec, device, masters0, aux0, images, labels)
    ref_loss, ref_upd = runs['step']
    upd = _concat_update(names, masters0, seen['after1'])
    loss_err = abs(seen['loss'][0] - ref_loss) / abs(ref_loss)
    upd_err = rel_rms(upd, ref_upd)
    log('  batch 1 against graph_train\'s f32 step: loss %.6f / %.6f '
        '(relative error %.3e, held to %g); update, relative RMS error %.3e '
        '(held to %g; the f32 step against itself run again %.3e, with the '
        'images moved by 1e-6 %.3e)'
        % (seen['loss'][0], ref_loss, loss_err, FIT_LOSS_RTOL, upd_err,
           FIT_UPDATE_REL_RMS, rel_rms(runs['again'][1], ref_upd),
           rel_rms(runs['moved'][1], ref_upd)))
    check(loss_err <= FIT_LOSS_RTOL, 'batch 1\'s loss disagrees with the step')
    check(upd_err <= FIT_UPDATE_REL_RMS,
          'batch 1\'s update disagrees with the step')

    # save_checkpoint, Module.load into a fresh module, predict
    one = mt.io.NDArrayIter(X[:batch], y[:batch], batch_size=batch)
    want = mod.predict(one).handle
    with tempfile.TemporaryDirectory() as tmp:
        prefix = ckpt or os.path.join(tmp, 'resnet')
        mod.save_checkpoint(prefix, 1)
        loaded = mt.mod.Module.load(prefix, 1, context=ctx)
        loaded.bind(one.provide_data, one.provide_label, for_training=False)
    got = loaded.predict(one).handle
    same = bool(torch.equal(got, want))
    log('  save_checkpoint, Module.load and predict on one batch: %s '
        '(max abs difference %.3e)'
        % ('bit for bit' if same else 'NOT bit for bit',
           float((got - want).abs().max())))
    check(same, 'the loaded module predicts otherwise')

    split = fit_split(mod, train, device)
    log('  where a fit batch goes (host wall ms, each part waited for on '
        'the card, medians over batches 2-4): forward with the batch\'s copy '
        'in %.3f, backward %.3f, update (%d sgd_mom_update calls) %.3f, the '
        'acc metric %.3f: %.3f in all; graph_train\'s f32 step on the same '
        'batch %.3f ms'
        % (split[0], split[1], len(names), split[2], split[3], sum(split),
           runs['step_wall_ms']))
    del mod, loaded, group, bound, want, got
    return dict(masters=masters0, aux=aux0, images=images, labels=labels,
                names=names, ref=runs['step'], fit_s=fit_s,
                batch_ms=batch_ms, wall_ms=wall_ms, speed=seen['speed'])


def module_kernels(device, cfg, batches=MODULE_BATCHES, profile=None):
    """Phase (l2): phase (k2)'s head, MakeLoss(softmax_cross_entropy(Cast(
    FullyConnected(LayerNorm(x)), f32), label)), at bench's widths through
    Module.fit for one epoch and then Module.score, with K4's and K3's
    launches counted in each; each batch's loss against the plain versions
    on the same parameters. Returns {wrapper: launches in fit and score}.
    With ``profile`` (phase (p2)) the fit and the score run inside
    ``mx.profiler.Profiler`` writing to that path."""
    import contextlib
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    sym = mt.sym
    N, D, V = MAX_BATCH * cfg.seq_len, cfg.d_model, cfg.vocab
    on_card = device.type == 'cuda'
    ctx = mt.gpu(device.index or 0) if on_card else mt.cpu()
    x = sym.var('x')
    logits = sym.Cast(sym.FullyConnected(sym.LayerNorm(x, name='ln'),
                                         num_hidden=V, no_bias=True,
                                         name='head'), dtype='float32')
    net = sym.MakeLoss(sym.softmax_cross_entropy(logits, sym.var('label')))
    rng = np.random.RandomState(22)
    X = rng.standard_normal((batches * N, D)).astype(np.float32)
    y = rng.randint(0, V, batches * N).astype(np.int32)
    it = mt.io.NDArrayIter({'x': X}, {'label': y}, batch_size=N)
    mod = mt.mod.Module(net, data_names=('x',), label_names=('label',),
                        context=ctx)
    mod.bind(it.provide_data, it.provide_label)
    mt.random.seed(0)
    mod.init_params(_xavier())
    state = {'before': {n: a.handle.detach().clone()
                        for n, a in mod.get_params()[0].items()}}
    errs = []

    def against_plain(param):
        # the batch's loss against the plain versions on the parameters it
        # ran with (those before this batch's update in fit)
        data_batch = param.locals.get('data_batch') or \
            param.locals['eval_batch']
        p = state['before']
        xb = data_batch.data[0].handle.to(device)
        lab = data_batch.label[0].handle.to(device)
        h = ck.layernorm_ref(xb, p['ln_gamma'], p['ln_beta'])
        ref = float(ck.softmax_xent_ref((h @ p['head_weight'].t()).float(),
                                        lab).sum())
        got = float(mod.get_outputs()[0].asnumpy().sum())
        errs.append(abs(got - ref) / abs(ref))
        state['before'] = {n: a.handle.detach().clone()
                           for n, a in mod.get_params()[0].items()}

    counters = (ck.layernorm_fwd, ck.rmsnorm_fwd, ck.softmax_fwd,
                ck.softmax_xent_fwd)
    launches = {}
    around = mt.profiler.Profiler(mode='all', filename=profile) if profile \
        else contextlib.nullcontext()
    with around:
        # the main path: counts are zeroed just before and read just after
        for fwd in counters:
            fwd.launches = 0
        mod.fit(it, num_epoch=1, optimizer='sgd', optimizer_params=FIT_OPT,
                eval_metric='loss', kvstore='device',
                batch_end_callback=against_plain)
        mod.get_outputs()[0].wait_to_read()
        launches['fit'] = {fwd.__name__: fwd.launches for fwd in counters}
        for fwd in counters:
            fwd.launches = 0
        res = mod.score(it, 'loss', batch_end_callback=against_plain)
        mod.get_outputs()[0].wait_to_read()
        launches['score'] = {fwd.__name__: fwd.launches for fwd in counters}
        if on_card:
            # every launch ends inside the device trace's window
            torch.cuda.synchronize()
    want = {'layernorm_fwd': batches, 'rmsnorm_fwd': 0, 'softmax_fwd': 0,
            'softmax_xent_fwd': batches}
    if not on_card:
        want = dict.fromkeys(want, 0)
    log('  Module(x [%d, %d] f32 -> LayerNorm -> FullyConnected to %d -> f32 '
        '-> softmax_cross_entropy -> MakeLoss): fit, one epoch of %d batches, '
        'launches %s; score %s (loss %.4f)'
        % (N, D, V, batches, launches['fit'], launches['score'], res[0][1]))
    check(launches['fit'] == want and launches['score'] == want,
          'Module launches %s != %s each' % (launches, want))
    log('  each batch\'s loss against the plain versions\' (fit, then '
        'score): relative errors %s' % ['%.3e' % e for e in errs])
    check(len(errs) == 2 * batches and max(errs) <= MODULE_LOSS_RTOL,
          'a batch\'s loss through Module disagrees with the plain versions')
    del mod, state
    return {n: launches['fit'][n] + launches['score'][n]
            for n in launches['fit']}


def gluon_loop(device, fitted, spec=RESNET, steps=2):
    """Phase (l3): the same net imperative under autograd.record() with
    SoftmaxCrossEntropyLoss, backward and gluon.Trainer.step(batch) for
    ``steps`` steps; step 1's loss and update against (l1)'s f32 step."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision
    name, batch, image, classes = spec
    on_card = device.type == 'cuda'
    ctx = mt.gpu(device.index or 0) if on_card else mt.cpu()
    with mt.name.NameManager():
        net = vision.get_model(name, classes=classes)
    net.initialize(ctx=ctx)
    x = nd.from_torch(fitted['images'], ctx)
    lab = nd.from_torch(fitted['labels'], ctx)
    with autograd.pause():
        net(x)                              # deferred initialisation
    values = {n: t.cpu().numpy() for n, t in fitted['masters'].items()
              if n != 'data'}
    values.update({n: t.cpu().numpy() for n, t in fitted['aux'].items()})
    gluon.params_from_numpy(net, values)
    params = net.collect_params()
    trainer = gluon.Trainer(params, 'sgd', dict(FIT_OPT))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for i in range(steps):
        with autograd.record():
            loss = loss_fn(net(x), lab)
        loss.backward()
        trainer.step(batch)
        losses.append(float(loss.mean().asscalar()))
        if i == 0:
            after = {n: p.data(ctx).handle.detach().clone()
                     for n, p in params.items() if p.grad_req != 'null'}
    on = [p.data(ctx).handle.device.type for p in params.values()]
    check(all(d == device.type for d in on),
          'a parameter left %s in Trainer.step' % device.type)
    names = fitted['names']
    upd = _concat_update(names, fitted['masters'], after)
    ref_loss, ref_upd = fitted['ref']
    loss_err = abs(losses[0] - ref_loss) / abs(ref_loss)
    upd_err = rel_rms(upd, ref_upd)
    log('  Gluon %s imperative, SoftmaxCrossEntropyLoss, Trainer(sgd).step(%d) '
        'on %s: losses %s; step 1 against (l1)\'s f32 step: loss relative '
        'error %.3e (held to %g), update relative RMS error %.3e (held to %g)'
        % (name, batch, device.type, ['%.6f' % v for v in losses], loss_err,
           FIT_LOSS_RTOL, upd_err, FIT_UPDATE_REL_RMS))
    check(all(np.isfinite(losses)), 'the Gluon loop\'s loss is not finite')
    check(loss_err <= FIT_LOSS_RTOL, 'the Gluon step\'s loss disagrees')
    check(upd_err <= FIT_UPDATE_REL_RMS, 'the Gluon step\'s update disagrees')


# ---------------------------------------------------------------------------
# (m) the fused W-step windows of Module.fit, score and predict
# ---------------------------------------------------------------------------

WINDOW_BATCHES = 10     # (m1): two windows of W = 4 and a tail of two
WINDOW_SCORED = 8       # (m1)'s score and predict: two eval windows
# (m1) holds the masters after the first window (4 steps) against 4 steps
# of the per-batch loop (MXTPU_FUSED_FIT=0) from the same masters, aux
# states and momentum, as a relative RMS of the change, each run twice for
# the floor. With cuDNN's default algorithms the floor is no floor: the
# backward sums in an order of its own each call (one f32 step's spread is
# 1.0e-5, (l1)), and at this initialisation four steps at lr 0.1 carry that
# to 0.38 on the H100 (the loss climbs from 8 to 22). So the check runs
# with cuDNN's deterministic algorithms (torch.backends.cudnn.deterministic),
# where the per-batch loop repeats itself bit for bit (a floor of 0 on the
# H100): the window runs the same ops on the same values, so the bound is
# 0, bit for bit. The default algorithms' figures are printed beside it.
WINDOW_UPDATE_REL_RMS = 0.0
# (m1)'s score with and without the window: the same forwards on the same
# parameters and batches, the statistics summed on the card against numpy's
# sums on the host: acc equal, ce 1e-5 relative. predict: the same ops on
# the same inputs, each batch a contiguous slice of the window's stack
# against the bound array; cuDNN may pick another algorithm for another
# call, so within 1e-5 relative (1e-6 absolute, the outputs are
# probabilities), bit for bit printed beside it.
WINDOW_CE_RTOL = 1e-5
WINDOW_PREDICT_RTOL = (1e-5, 1e-6)
# (m2): each batch's loss in fit against the plain versions' trajectory
# from the same parameters (the same update op on the plain versions'
# gradients), and in score against the plain versions on the same
# parameters, at (k2)'s tolerance
WINDOW_LOSS_RTOL = EXEC_LOSS_RTOL
WINDOW_KERNEL_BATCHES = 4


class _flags_set:
    """Set environment flags of the port for a block, restoring them after
    (the port caches its flags: each is reloaded on the way in and out)."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        from mxnet_tpu_torch.config import flags
        self.old = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)
        flags.reload()

    def __exit__(self, *exc):
        from mxnet_tpu_torch.config import flags
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        flags.reload()


def _per_batch():
    return _flags_set(MXTPU_FUSED_FIT='0', MXTPU_FUSED_EVAL='0')


def _timed_windows(device, record):
    """Wrap FusedFitLoop's window programs while the block runs: each call
    appends (start event, end event, host wall ms, synchronising calls
    inside it, the carried parameters it returned) to ``record``. On the
    card torch's sync debug mode warns of every call inside the window
    that synchronises the host with the device."""
    import contextlib
    import warnings
    import torch
    from mxnet_tpu_torch.module.fused_fit import FusedFitLoop
    on_card = device.type == 'cuda'
    orig = FusedFitLoop._build_program

    def build(self, static_attrs):
        fn = orig(self, static_attrs)
        names = list(self._carry_names)

        def timed(*args):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] \
                if on_card else None
            if ev:
                ev[0].record()
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter('always')
                if on_card:
                    torch.cuda.set_sync_debug_mode('warn')
                try:
                    out = fn(*args)
                finally:
                    if on_card:
                        torch.cuda.set_sync_debug_mode(0)
            wall = (time.perf_counter() - t0) * 1e3
            if ev:
                ev[1].record()
            syncs = [str(w.message) for w in caught
                     if 'called a synchronizing CUDA operation'
                     in str(w.message)]
            record.append((ev, wall, syncs,
                           {n: t.detach().clone()
                            for n, t in zip(names, out[0])}))
            return out
        return timed

    @contextlib.contextmanager
    def patched():
        FusedFitLoop._build_program = build
        try:
            yield
        finally:
            FusedFitLoop._build_program = orig
    return patched()


def window_fit(device, spec=RESNET, per_batch=None,
               n_batches=WINDOW_BATCHES):
    """Phase (m1): train_imagenet's recipe (as (l1)) through the default,
    windowed Module.fit over ``n_batches`` batches: two windows and a tail;
    the host's fetches a window, the callbacks' order, the losses, window
    1's masters against 4 per-batch steps, score and predict with and
    without the window, and a window batch's times beside (l1)'s per-batch
    ones (``per_batch``)."""
    import logging
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.module.window_pipeline import window_size
    name, batch, image, classes = spec
    on_card = device.type == 'cuda'
    ctx = mt.gpu(device.index or 0) if on_card else mt.cpu()
    W = window_size()
    check(W == 4, 'the fit window is %d steps, not 4' % W)
    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    X = rng.standard_normal((n_batches * batch, 3, image, image)).astype(
        np.float32)
    y = rng.randint(0, classes, n_batches * batch).astype(np.int32)
    train = mt.io.NDArrayIter(X, y, batch_size=batch)
    sym = _zoo_symbol(name, classes, (batch, 3, image, image))
    mod = mt.mod.Module(sym) if on_card else mt.mod.Module(sym, context=ctx)
    mod.bind(train.provide_data, train.provide_label)
    mt.random.seed(0)
    mod.init_params(_xavier())
    args, aux = mod.get_params()
    masters0 = {n: a.handle.detach().clone() for n, a in args.items()}
    aux0 = {n: a.handle.detach().clone() for n, a in aux.items()}
    log('  Module(%s under SoftmaxOutput) on %s, W = %d, %d batches of %d '
        'from seed 0; set up in %.1f s'
        % (name, mod._context, W, n_batches, batch, time.perf_counter() - t0))

    seen = {'batches': [], 'loss': [], 'speed': []}
    prev = {'ce': (0.0, 0)}

    def per_batch_cb(param):
        # the batch's loss from the CE statistic's increment (the metric is
        # reset by the Speedometer every 4 batches)
        seen['batches'].append((param.epoch, param.nbatch))
        ce = param.eval_metric.get_metric(1)
        cur = (ce.sum_metric, ce.num_inst)
        if cur[1] < prev['ce'][1]:
            prev['ce'] = (0.0, 0)
        seen['loss'].append((cur[0] - prev['ce'][0]) /
                            max(cur[1] - prev['ce'][1], 1))
        prev['ce'] = cur

    class Speeds(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if 'Speed:' in msg:
                seen['speed'].append(float(msg.split('Speed: ')[1].split()[0]))
    handler = Speeds()
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    windows = []
    t0 = time.perf_counter()
    try:
        with _timed_windows(device, windows):
            # eval_metric: (l1)'s acc, with ce beside it for the losses,
            # which the window keeps on the card: both are statistics in
            # the same single fetch a window
            mod.fit(train, num_epoch=1, optimizer='sgd',
                    optimizer_params=FIT_OPT, initializer=_xavier(),
                    eval_metric=['acc', 'ce'], kvstore='device',
                    batch_end_callback=[per_batch_cb, mt.callback.Speedometer(
                        batch, FIT_SPEEDOMETER)])
        if on_card:
            torch.cuda.synchronize()
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    fit_s = time.perf_counter() - t0
    loop = mod.__dict__['_fused_fit_cache'][1]
    log('  fit, one epoch of %d batches in %.2f s: %d windows, %d tail '
        'batches, %d host fetches of window results; losses %s'
        % (n_batches, fit_s, loop.windows, loop.tail_batches, loop.fetches,
           ['%.6f' % v for v in seen['loss']]))
    tail = n_batches % W
    check((loop.windows, loop.tail_batches) == (n_batches // W, tail),
          'the fit ran %d windows and %d tail batches, not %d and %d'
          % (loop.windows, loop.tail_batches, n_batches // W, tail))
    check(loop.fetches == loop.windows,
          'the host fetched %d times for %d windows'
          % (loop.fetches, loop.windows))
    check(seen['batches'] == [(0, i) for i in range(n_batches)],
          'the batch_end_callback saw %s' % seen['batches'])
    check(len(seen['loss']) == n_batches and all(np.isfinite(seen['loss'])),
          'a batch\'s loss is not finite')
    syncs = [s for _, _, ss, _ in windows for s in ss]
    log('  synchronising calls inside the windows (torch sync debug mode): '
        '%s' % (len(syncs) if on_card else 'not measured off the card'))
    check(not syncs, 'the window synchronised with the device: %s'
          % syncs[:3])

    # a window batch's time: the second window (the first pays its first
    # calls), by CUDA events and host wall time, over its W steps
    ev, wall, _, _ = windows[-1]
    win_ms = ev[0].elapsed_time(ev[1]) / W if ev else None
    wall_ms = wall / W
    pb = per_batch or {}
    log('  a window batch (window 2 / %d): %s by CUDA events, %.3f ms of '
        'host wall time (%.1f images/s); Speedometer %s samples/s; 1 fetch '
        'a window. The per-batch loop of (l1), this run: %s by CUDA events, '
        '%s of host wall time; Speedometer %s samples/s'
        % (W, '%.3f ms' % win_ms if win_ms else 'not measured', wall_ms,
           batch / (win_ms or wall_ms) * 1e3, seen['speed'],
           '%.3f ms' % pb['batch_ms'] if pb.get('batch_ms') else
           'not measured',
           '%.3f ms' % pb['wall_ms'] if pb.get('wall_ms') else
           'not measured', pb.get('speed')))

    # window 1's masters against 4 per-batch steps from the same state:
    # with cuDNN's default algorithms (as the fit above ran) and again with
    # its deterministic ones, each per-batch run twice for the floor
    names = sorted(masters0)
    four = mt.io.NDArrayIter(X[:W * batch], y[:W * batch], batch_size=batch)

    def four_steps(fused):
        mod.set_params({n: mt.nd.from_torch(t.clone(), ctx)
                        for n, t in masters0.items()},
                       {n: mt.nd.from_torch(t.clone(), ctx)
                        for n, t in aux0.items()})
        mod.init_optimizer(kvstore='device', optimizer='sgd',
                           optimizer_params=FIT_OPT, force_init=True)
        with _flags_set(MXTPU_FUSED_FIT='1' if fused else '0'):
            mod.fit(four, num_epoch=1, optimizer='sgd',
                    optimizer_params=FIT_OPT, eval_metric=['acc', 'ce'],
                    kvstore='device')
        check(('_fused_fit_cache' in mod.__dict__) == fused,
              'the 4 steps did not take the %s loop'
              % ('windowed' if fused else 'per-batch'))
        return _concat_update(names, masters0, {
            n: a.handle.detach() for n, a in mod.get_params()[0].items()})

    default = (_concat_update(names, masters0, windows[0][3]),
               four_steps(False), four_steps(False))
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        det = (four_steps(True), four_steps(False), four_steps(False))
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    errs = {k: (rel_rms(v[0], v[1]), rel_rms(v[2], v[1]))
            for k, v in (('default', default), ('deterministic', det))}
    err, floor = errs['deterministic']
    log('  masters after window 1 against 4 per-batch steps from the same '
        'masters, aux states and momentum, update relative RMS error: with '
        'cuDNN\'s default algorithms %.3e (the per-batch steps against '
        'themselves run again %.3e); with its deterministic ones %.3e (held '
        'to %g; again %.3e)' % (errs['default'] + (err, WINDOW_UPDATE_REL_RMS,
                                                   floor)))
    check(err <= WINDOW_UPDATE_REL_RMS,
          'window 1 disagrees with 4 per-batch steps')

    # score and predict with the window and without it, on the trained
    # module over the same batches
    res = {}
    for fused in (True, False):
        with _flags_set(MXTPU_FUSED_EVAL='1' if fused else '0'):
            scored = dict(mod.score(train, ['acc', 'ce'],
                                    num_batch=WINDOW_SCORED))
            pred = mod.predict(train, num_batch=WINDOW_SCORED).handle
            if fused:
                score_loop = mod.__dict__['_fused_eval_cache']['score'][1]
        res[fused] = (scored, pred.to(device))
    (s_w, p_w), (s_b, p_b) = res[True], res[False]
    ce_err = abs(s_w['cross-entropy'] - s_b['cross-entropy']) / \
        abs(s_b['cross-entropy'])
    same = bool(torch.equal(p_w, p_b))
    rtol, atol = WINDOW_PREDICT_RTOL
    log('  score over %d batches, window / per-batch: acc %.6f / %.6f, ce '
        '%.6f / %.6f (relative %.3e, held to %g); %d score windows, %d '
        'fetches; predict %s (max abs difference %.3e; held to rtol %g, atol '
        '%g)' % (WINDOW_SCORED, s_w['accuracy'], s_b['accuracy'],
                 s_w['cross-entropy'], s_b['cross-entropy'], ce_err,
                 WINDOW_CE_RTOL, score_loop.windows, score_loop.fetches,
                 'bit for bit' if same else 'NOT bit for bit',
                 float((p_w - p_b).abs().max()), rtol, atol))
    check(s_w['accuracy'] == s_b['accuracy'], 'the windowed score\'s acc '
          'differs')
    check(ce_err <= WINDOW_CE_RTOL, 'the windowed score\'s ce differs')
    check(score_loop.windows == WINDOW_SCORED // W and
          score_loop.fetches == WINDOW_SCORED // W,
          'the score windows or their fetches are off')
    check(p_w.shape == p_b.shape and torch.allclose(p_w, p_b, rtol=rtol,
                                                    atol=atol),
          'the windowed predict differs')
    del mod
    return dict(win_ms=win_ms, wall_ms=wall_ms, err=err, floor=floor)


def window_kernels(device, cfg, batches=WINDOW_KERNEL_BATCHES):
    """Phase (m2): (l2)'s head through the default, windowed Module.fit
    (one window of 4 steps, 'loss' in host-metric mode) and Module.score
    (one window), K4's and K3's launches counted in each; each batch's loss
    against the plain versions. Returns {wrapper: launches in fit and
    score}."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.ops import registry
    sym = mt.sym
    N, D, V = MAX_BATCH * cfg.seq_len, cfg.d_model, cfg.vocab
    on_card = device.type == 'cuda'
    ctx = mt.gpu(device.index or 0) if on_card else mt.cpu()
    x = sym.var('x')
    logits = sym.Cast(sym.FullyConnected(sym.LayerNorm(x, name='ln'),
                                         num_hidden=V, no_bias=True,
                                         name='head'), dtype='float32')
    net = sym.MakeLoss(sym.softmax_cross_entropy(logits, sym.var('label')))
    rng = np.random.RandomState(23)
    X = rng.standard_normal((batches * N, D)).astype(np.float32)
    y = rng.randint(0, V, batches * N).astype(np.int32)
    it = mt.io.NDArrayIter({'x': X}, {'label': y}, batch_size=N)
    mod = mt.mod.Module(net, data_names=('x',), label_names=('label',),
                        context=ctx)
    mod.bind(it.provide_data, it.provide_label)
    mt.random.seed(0)
    mod.init_params(_xavier())
    p0 = {n: a.handle.detach().clone() for n, a in mod.get_params()[0].items()}
    sums = []

    def loss_sum(param):
        sums.append(param.eval_metric.sum_metric)

    counters = (ck.layernorm_fwd, ck.rmsnorm_fwd, ck.softmax_fwd,
                ck.softmax_xent_fwd)
    launches = {}
    # the main path: counts are zeroed just before and read just after
    for fwd in counters:
        fwd.launches = 0
    mod.fit(it, num_epoch=1, optimizer='sgd', optimizer_params=FIT_OPT,
            eval_metric='loss', kvstore='device', batch_end_callback=loss_sum)
    if on_card:
        torch.cuda.synchronize()
    launches['fit'] = {fwd.__name__: fwd.launches for fwd in counters}
    fit_losses = list(np.diff([0.0] + sums))
    sums.clear()
    for fwd in counters:
        fwd.launches = 0
    res = mod.score(it, 'loss', batch_end_callback=loss_sum)
    if on_card:
        torch.cuda.synchronize()
    launches['score'] = {fwd.__name__: fwd.launches for fwd in counters}
    score_losses = list(np.diff([0.0] + sums))
    fit_loop = mod.__dict__['_fused_fit_cache'][1]
    score_loop = mod.__dict__['_fused_eval_cache']['score'][1]
    want = {'layernorm_fwd': batches, 'rmsnorm_fwd': 0, 'softmax_fwd': 0,
            'softmax_xent_fwd': batches}
    if not on_card:
        want = dict.fromkeys(want, 0)
    log('  Module(x [%d, %d] f32 -> LayerNorm -> FullyConnected to %d -> f32 '
        '-> softmax_cross_entropy -> MakeLoss), %d batches: fit, %d window '
        '(host-metric mode: %s), %d tail batches, launches %s; score, %d '
        'window, launches %s (loss %.4f)'
        % (N, D, V, batches, fit_loop.windows, fit_loop.stat_fns is None,
           fit_loop.tail_batches, launches['fit'], score_loop.windows,
           launches['score'], res[0][1]))
    check((fit_loop.windows, fit_loop.tail_batches, score_loop.windows) ==
          (1, 0, 1), 'the head did not run one fit and one score window')
    check(launches['fit'] == want and launches['score'] == want,
          'window launches %s != %s each' % (launches, want))

    # the plain versions: fit's trajectory from the same parameters (the
    # update op the window runs, on the plain versions' gradients), then
    # score on the trained parameters
    def plain_loss(p, xb, lab):
        h = ck.layernorm_ref(xb, p['ln_gamma'], p['ln_beta'])
        return ck.softmax_xent_ref((h @ p['head_weight'].t()).float(),
                                   lab).sum()

    sgd = registry.get('sgd_mom_update').fn
    p = dict(p0)
    mom = {n: torch.zeros_like(t) for n, t in p.items()}
    ref_fit = []
    for b in range(batches):
        xb = torch.from_numpy(X[b * N:(b + 1) * N]).to(device)
        lab = torch.from_numpy(y[b * N:(b + 1) * N]).to(device)
        leaves = {n: t.detach().requires_grad_() for n, t in p.items()}
        loss = plain_loss(leaves, xb, lab)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        ref_fit.append(float(loss.detach()))
        with torch.no_grad():
            for (n, t), g in zip(p.items(), grads):
                attrs = dict(lr=FIT_OPT['learning_rate'],
                             momentum=FIT_OPT['momentum'],
                             wd=FIT_OPT['wd'] if n.endswith(
                                 ('_weight', '_gamma')) else 0.0,
                             rescale_grad=1.0 / N, clip_gradient=-1.0)
                p[n], mom[n] = sgd(attrs, t, g, mom[n])
    trained = {n: a.handle.detach() for n, a in mod.get_params()[0].items()}
    ref_score = []
    with torch.no_grad():
        for b in range(batches):
            xb = torch.from_numpy(X[b * N:(b + 1) * N]).to(device)
            lab = torch.from_numpy(y[b * N:(b + 1) * N]).to(device)
            ref_score.append(float(plain_loss(trained, xb, lab)))
    errs = [abs(a - b) / abs(b) for a, b in zip(fit_losses + score_losses,
                                                ref_fit + ref_score)]
    log('  each batch\'s loss against the plain versions\' (fit: their '
        'trajectory from the same parameters; score: on the trained '
        'parameters): relative errors %s' % ['%.3e' % e for e in errs])
    check(len(errs) == 2 * batches and max(errs) <= WINDOW_LOSS_RTOL,
          'a batch\'s loss through the window disagrees with the plain '
          'versions')
    del mod
    return {n: launches['fit'][n] + launches['score'][n]
            for n in launches['fit']}


# ---------------------------------------------------------------------------
# (n) the serving plane on the card
# ---------------------------------------------------------------------------

# (n1): train_imagenet's fitted ResNet-50 from (l1)'s checkpoint, served
# over HTTP. 8 client threads send 4 .npy requests each of 1-8 images
# (sizes from RandomState(0)), and one JSON request of 1 image; before
# them a lone request of 32 images, a full bucket.
SERVE_MAX_BATCH = 32
SERVE_CLIENTS = 8
SERVE_CLIENT_REQUESTS = 4
SERVE_WAIT_MS = 5.0
# Each answer against Module.predict (per-batch, at batch 32) on the same
# images. A full bucket runs the runner on the same 32 rows as predict's
# batch, with cuDNN's deterministic algorithms: bit for bit. Another bucket
# size runs other cuDNN algorithms (another summation order, or a Winograd
# transform) in each of the 53 convolutions: a few f32 ulps a layer, about
# 1e-5 relative in the logits. Relative RMS error of a request's answer
# 1e-3, a hundred times that estimate; probabilities are compared as logs
# (floored at 1e-30), where a logit's error shows as itself. The checkpoint
# this recipe fits answers every image alike (one-hot probabilities: its
# loss diverges to about 20 in 8 steps at lr 0.1; the initial net's too, its
# activations grow through the 16 residual blocks), so no comparison of its
# answers can tell a wrong row or a pad row. (n1) therefore also serves the
# initial checkpoint's graph cut below SoftmaxOutput, its logits, which
# differ from image to image (the spread between two images' answers is
# printed and must exceed ten times the bound).
SERVE_RESNET_REL_RMS = 1e-3
# (n2): bench's decoder behind the batcher: 4 threads, 12 requests of 1-3
# rows of 1024 tokens in all, the logits held as (d) holds them.
DECODER_THREADS = 4
DECODER_REQUESTS = 12
# (n3): the decoder's head as a served Module (LayerNorm -> FullyConnected
# to V, no bias -> softmax, per example (1024,) f32), from a checkpoint,
# max_batch 64, requests of 1-40 rows from 4 threads. Its probabilities
# against the plain versions on the same parameters: LayerNorm's kernel and
# plain version agree to a few f32 ulps, the matmul is cuBLAS's on both
# sides (at another row count: another summation order), and the
# probabilities are about 1/V: 1e-5 absolute, the issue's bound, is far
# above that and far below a wrong row's error (one 1/V).
HEAD_MAX_BATCH = 64
HEAD_REQUESTS = 12
HEAD_MAX_ROWS = 40
HEAD_ATOL = 1e-5


class _telemetry_on(_flags_set):
    """The port's telemetry on for a block, its JSONL log at ``path``.
    Telemetry is decided once a process: it is decided again on the way in
    and out (``_reset_for_tests`` drops the decision)."""

    def __init__(self, path):
        super().__init__(MXTPU_TELEMETRY='1', MXTPU_TELEMETRY_PATH=path)

    def __enter__(self):
        from mxnet_tpu_torch import telemetry
        super().__enter__()
        telemetry._reset_for_tests()
        check(telemetry.enabled(), 'telemetry did not come on')

    def __exit__(self, *exc):
        from mxnet_tpu_torch import telemetry
        telemetry.shutdown()
        super().__exit__(*exc)
        telemetry._reset_for_tests()


def _http(port, path, body=None, headers=None, timeout=120):
    """(status, headers, body) of one request to the serving port."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request('http://127.0.0.1:%d%s' % (port, path),
                                 data=body, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _npy_bytes(a):
    import io
    buf = io.BytesIO()
    np.save(buf, a, allow_pickle=False)
    return buf.getvalue()


def _pct(values, p):
    return float(np.percentile(np.asarray(values, np.float64), p))


def _np_rel_rms(got, want):
    a, b = np.float64(got), np.float64(want)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def _log_rel_rms(got, want):
    """Relative RMS error of probabilities compared as logs (floored at
    1e-30)."""
    return _np_rel_rms(np.log(np.maximum(got, 1e-30, dtype=np.float64)),
                       np.log(np.maximum(want, 1e-30, dtype=np.float64)))


def _logits_checkpoint(ckpt, epoch, out):
    """Save at ``out`` the checkpoint's graph cut below its SoftmaxOutput
    (the last FullyConnected's logits), with the same parameters."""
    import mxnet_tpu_torch as mt
    sym, args, aux = mt.model.load_checkpoint(ckpt, epoch)
    mt.model.save_checkpoint(out, epoch, sym.get_children()[0], args, aux)


def _builds():
    from mxnet_tpu_torch import telemetry
    return telemetry.snapshot()['histograms'].get('serve.build',
                                                  {}).get('count', 0)


def _burst(n_threads, jobs, fn):
    """Run ``fn(job)`` for each job from ``n_threads`` threads started
    together; returns ([(job, result, seconds)], wall seconds)."""
    import threading
    per = [jobs[i::n_threads] for i in range(n_threads)]
    out, errors = [], []
    barrier = threading.Barrier(n_threads, timeout=120)

    def worker(mine):
        try:
            barrier.wait()
            for job in mine:
                t = time.perf_counter()
                res = fn(job)
                out.append((job, res, time.perf_counter() - t))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(m,)) for m in per]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), 'a client thread hung')
    if errors:
        raise errors[0]
    return out, wall


def _batcher_line(b, wall, unit_per_row, unit):
    rows = [r for r, _, _ in b.dispatch_log]
    padded = [bk for _, bk, _ in b.dispatch_log]
    pad = 1 - sum(rows) / sum(padded)
    log('    %d dispatches, %.2f rows a dispatch (requests a dispatch %s), '
        'pad fraction %.4f; queue wait p50 %.3f ms; %.1f %s/s over the '
        'burst\'s %.3f s'
        % (len(rows), statistics.mean(rows),
           [n for _, _, n in b.dispatch_log], pad,
           _pct(b.queue_wait_log, 50), sum(rows) * unit_per_row / wall, unit,
           wall))
    return pad


def serve_resnet(device, ckpt, epoch, spec=RESNET, logits=False):
    """Phase (n1): the checkpoint ``ckpt``/``epoch`` (probabilities, or
    with ``logits`` the graph's logits) through
    ServingEngine.from_checkpoint, DynamicBatcher and the HTTP server,
    against Module.predict. Returns the spread between two images'
    answers."""
    import io
    import json
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serving import DynamicBatcher, ServingEngine
    from mxnet_tpu_torch.serving.http import start_server
    name, _, image, classes = spec
    on_card = device.type == 'cuda'
    ctx = mt.gpu(device.index or 0) if on_card else mt.cpu()
    shape = (3, image, image)
    sizes = np.random.RandomState(0).randint(
        1, 9, (SERVE_CLIENTS, SERVE_CLIENT_REQUESTS))
    # the pool: the full bucket's 32 images, then each client request's,
    # then the JSON request's one
    n = SERVE_MAX_BATCH + int(sizes.sum()) + 1
    n_pad = -(-n // SERVE_MAX_BATCH) * SERVE_MAX_BATCH
    pool = np.zeros((n_pad,) + shape, np.float32)
    pool[:n] = np.random.RandomState(1).standard_normal((n,) + shape)
    starts = SERVE_MAX_BATCH + np.concatenate(
        [[0], np.cumsum(sizes.ravel())])[:-1].reshape(sizes.shape)

    # the reference: Module.predict per batch of 32 on the same checkpoint
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with _per_batch():
            t0 = time.perf_counter()
            ref_mod = mt.mod.Module.load(ckpt, epoch, label_names=[],
                                         context=ctx)
            ref_mod.bind([('data', (SERVE_MAX_BATCH,) + shape)],
                         for_training=False)
            ref = ref_mod.predict(mt.io.NDArrayIter(
                pool, None, batch_size=SERVE_MAX_BATCH)).asnumpy()
            del ref_mod
            log('  reference: Module.predict over %d images in batches of '
                '%d, %.1f s' % (n_pad, SERVE_MAX_BATCH,
                                time.perf_counter() - t0))
        compare, what = ((_np_rel_rms, 'logits') if logits
                         else (_log_rel_rms, 'log-probabilities'))
        spread = compare(ref[1], ref[0])

        with _telemetry_on(os.path.join(os.path.dirname(ckpt),
                                        'serve-telemetry.jsonl')):
            t0 = time.perf_counter()
            engine = ServingEngine.from_checkpoint(
                ckpt, epoch, [('data', shape)], context=ctx,
                max_batch=SERVE_MAX_BATCH)
            check(engine.device == device, 'engine on %s' % engine.device)
            warmed = engine.warmup()
            built = _builds()
            log('  ServingEngine.from_checkpoint(%s) on %s, buckets %s warm '
                'in %.1f s (%d serve.build spans)'
                % (name, engine.device, engine.buckets,
                   time.perf_counter() - t0, built))
            check(warmed == len(engine.buckets) == built,
                  'warmup built %d programs for %d buckets'
                  % (built, len(engine.buckets)))
            batcher = DynamicBatcher(engine, max_wait_ms=SERVE_WAIT_MS)
            server = start_server(engine, batcher, port=0)
            try:
                port = server.port
                npy = {'Content-Type': 'application/x-npy',
                       'Accept': 'application/x-npy'}

                def ask(job):
                    i, j = job
                    lo = starts[i, j]
                    rid = 'n1-%d-%d' % (i, j)
                    code, hdrs, body = _http(
                        port, '/predict',
                        _npy_bytes(pool[lo:lo + sizes[i, j]]),
                        dict(npy, **{'X-Request-Id': rid}))
                    check(code == 200, 'request %s answered %d: %r'
                          % (rid, code, body[:200]))
                    check(hdrs['X-Request-Id'] == rid,
                          'X-Request-Id not echoed for %s' % rid)
                    return np.load(io.BytesIO(body), allow_pickle=False)

                # a lone full bucket first: bit for bit with predict
                code, hdrs, body = _http(port, '/predict',
                                         _npy_bytes(pool[:SERVE_MAX_BATCH]),
                                         npy)
                check(code == 200, 'the full bucket answered %d' % code)
                full = np.load(io.BytesIO(body), allow_pickle=False)
                same = bool(np.array_equal(full, ref[:SERVE_MAX_BATCH]))
                log('  a lone request of %d images (one full bucket) '
                    'against Module.predict\'s batch: %s (max abs %.3e)'
                    % (SERVE_MAX_BATCH,
                       'bit for bit' if same else 'NOT bit for bit',
                       float(np.abs(full - ref[:SERVE_MAX_BATCH]).max())))
                check(same, 'the full bucket disagrees with Module.predict')
                batcher.dispatch_log.clear()
                batcher.queue_wait_log.clear()

                jobs = [(i, j) for j in range(SERVE_CLIENT_REQUESTS)
                        for i in range(SERVE_CLIENTS)]
                answers, wall = _burst(SERVE_CLIENTS, jobs, ask)
                lo = n - 1
                t = time.perf_counter()
                code, hdrs, body = _http(
                    port, '/predict',
                    json.dumps({'data': pool[lo:lo + 1].tolist()}).encode(),
                    {'Content-Type': 'application/json'})
                json_s = time.perf_counter() - t
                check(code == 200, 'the JSON request answered %d' % code)
                payload = json.loads(body)
                json_out = np.asarray(payload['outputs'][0], np.float32)
                check(payload['rows'] == 1 and json_out.shape == (1, classes),
                      'the JSON answer has shape %s' % (json_out.shape,))
                worst = 0.0
                for (i, j), got, _ in answers:
                    lo = starts[i, j]
                    want = ref[lo:lo + sizes[i, j]]
                    check(got.shape == want.shape and np.isfinite(got).all(),
                          'answer %s has shape %s' % ((i, j), got.shape))
                    worst = max(worst, compare(got, want))
                json_err = compare(json_out, ref[n - 1:n])
                lat = [sec * 1e3 for _, _, sec in answers]
                log('  %d .npy requests of %s images from %d threads, and '
                    'one JSON request of 1 (%.2f ms, relative RMS error of '
                    'its %s %.3e)'
                    % (len(answers), sizes.tolist(), SERVE_CLIENTS,
                       json_s * 1e3, what, json_err))
                log('    request latency (host clock, client side): p50 %.2f '
                    'ms, p99 %.2f ms' % (_pct(lat, 50), _pct(lat, 99)))
                images = int(sizes.sum())
                _batcher_line(batcher, wall, 1, 'images')
                log('    %d images in %.3f s: %.1f images/s'
                    % (images, wall, images / wall))
                log('    each answer against Module.predict, %s: worst '
                    'relative RMS error %.3e (held to %g; two images\' '
                    'answers are %.3e apart)'
                    % (what, worst, SERVE_RESNET_REL_RMS, spread))
                check(worst <= SERVE_RESNET_REL_RMS
                      and json_err <= SERVE_RESNET_REL_RMS,
                      'a served answer disagrees with Module.predict')
                check(_builds() == built, 'serve.build went from %d to %d '
                      'after warmup' % (built, _builds()))
                log('    serve.build spans after the traffic: %d, as after '
                    'warmup' % _builds())
                code, _, body = _http(port, '/healthz')
                health = json.loads(body)
                check(code == 200 and health['status'] == 'ok',
                      '/healthz answered %d %s' % (code, health))
                code, _, body = _http(port, '/metrics')
                text = body.decode()
                q = [ln for ln in text.splitlines()
                     if ln.startswith('mxtpu_serve_request_latency_ms{')]
                check(code == 200 and any('quantile="0.5"' in ln for ln in q)
                      and any('quantile="0.95"' in ln for ln in q),
                      '/metrics carries no serve_request_latency quantiles')
                log('    /healthz 200 (%d requests, %d errors); /metrics: %s'
                    % (health['requests'], health['errors'], q))
                snap = telemetry.snapshot()
                log('    server side: serve.request_latency p50 %.2f ms, p95 '
                    '%.2f ms, p99 gauge %s ms; serve.queue_wait p50 %.3f ms'
                    % (snap['histograms']['serve.request_latency']['p50'],
                       snap['histograms']['serve.request_latency']['p95'],
                       snap['gauges'].get('serve.request_latency_p99_ms'),
                       snap['histograms']['serve.queue_wait']['p50']))
            finally:
                server.stop()
            del engine, batcher, server
    finally:
        torch.backends.cudnn.deterministic = prev
    return spread


def serve_decoder(device, cfg, model, ref, max_batch=MAX_BATCH):
    """Phase (n2): bench's decoder through ServingEngine.from_forward behind
    DynamicBatcher; K1's launches a dispatch and the logits against the
    plain-attention forward. Returns K1's launches."""
    import torch
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.serving import DynamicBatcher, ServingEngine
    engine = ServingEngine.from_forward(
        model, [('tokens', (cfg.seq_len,), np.int32)],
        output_names=['logits'], max_batch=max_batch, device=device,
        name='bench_transformer')
    engine.warmup()
    rng = np.random.RandomState(2)
    requests = [rng.randint(0, cfg.vocab, (int(r), cfg.seq_len))
                .astype(np.int32)
                for r in rng.randint(1, 4, DECODER_REQUESTS)]
    batcher = DynamicBatcher(engine, max_wait_ms=SERVE_WAIT_MS).start()
    try:
        # the main path: counts are zeroed just before and read just after
        ck.flash_fwd.launches = 0
        ck.flash_fwd.launches_by_body = dict.fromkeys(ck._BODIES, 0)
        answers, wall = _burst(
            DECODER_THREADS, list(range(len(requests))),
            lambda i: batcher.predict(requests[i], timeout=300)[0])
        launches = ck.flash_fwd.launches
        by_body = dict(ck.flash_fwd.launches_by_body)
    finally:
        batcher.close()
    n_disp = len(batcher.dispatch_log)
    want = cfg.n_layers * n_disp if device.type == 'cuda' else 0
    rows = [r.shape[0] for r in requests]
    log('  %d requests of %s rows from %d threads: %d flash launches in %d '
        'dispatches (%d a dispatch), by body %s'
        % (len(requests), rows, DECODER_THREADS, launches, n_disp,
           launches // max(n_disp, 1), by_body))
    check(launches == want and by_body.get('wgmma', 0) == launches,
          'flash launches %d (by body %s) != %d layers x %d dispatches on '
          'the wgmma body' % (launches, by_body, cfg.n_layers, n_disp))
    lat = [sec * 1e3 for _, _, sec in answers]
    log('    request latency (host clock): p50 %.2f ms, p99 %.2f ms'
        % (_pct(lat, 50), _pct(lat, 99)))
    _batcher_line(batcher, wall, cfg.seq_len, 'tokens')
    worst = {'rel_rms': 0.0, 'top_gap': 0.0}
    with torch.inference_mode():
        for i, got, _ in answers:
            got_t = on_device(got, device)
            check(got.shape == (rows[i], cfg.seq_len, cfg.vocab)
                  and bool(torch.isfinite(got_t).all()), 'logits shape/finite')
            want_t = ref(torch.from_numpy(requests[i]).to(device)).float()
            pick = got_t.argmax(-1, keepdim=True)
            worst['rel_rms'] = max(worst['rel_rms'], rel_rms(got_t, want_t))
            worst['top_gap'] = max(worst['top_gap'], float(
                (want_t.amax(-1) - want_t.gather(-1, pick)[..., 0]).max()))
            del got_t, want_t
    log('    logits vs the plain-attention forward: worst relative RMS %.3e '
        '(held to %g), reference logit at the served argmax at most %.4f '
        'below its max (held to %g)'
        % (worst['rel_rms'], LOGIT_REL_RMS, worst['top_gap'], ARGMAX_SLACK))
    check(worst['rel_rms'] <= LOGIT_REL_RMS
          and worst['top_gap'] <= ARGMAX_SLACK,
          'served logits disagree with the reference forward')
    return launches


def serve_head(device, cfg, work):
    """Phase (n3): the decoder's head as a Module checkpoint, served through
    from_checkpoint and the batcher; K4's and K5's launches a dispatch and
    the probabilities against the plain versions. Returns {wrapper:
    launches}."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.serving import DynamicBatcher, ServingEngine
    D, V = cfg.d_model, cfg.vocab
    on_card = device.type == 'cuda'
    ctx = mt.gpu(device.index or 0) if on_card else mt.cpu()
    S = mt.sym
    net = S.softmax(S.FullyConnected(S.LayerNorm(S.var('data'), eps=1e-5,
                                                 name='ln'),
                                     num_hidden=V, no_bias=True, name='head'),
                    axis=-1, name='probs')
    rng = np.random.RandomState(3)
    params = {'ln_gamma': 1 + 0.1 * rng.standard_normal(D),
              'ln_beta': 0.1 * rng.standard_normal(D),
              'head_weight': rng.standard_normal((V, D)) / np.sqrt(D)}
    mod = mt.mod.Module(net, label_names=[], context=mt.cpu())
    mod.bind([('data', (1, D))], for_training=False)
    mod.init_params(arg_params={k: mt.nd.array(v.astype(np.float32),
                                               ctx=mt.cpu())
                                for k, v in params.items()})
    prefix = os.path.join(work, 'head')
    mod.save_checkpoint(prefix, 0)
    engine = ServingEngine.from_checkpoint(prefix, 0, [('data', (D,))],
                                           context=ctx,
                                           max_batch=HEAD_MAX_BATCH)
    engine.warmup()
    sizes = rng.randint(1, HEAD_MAX_ROWS + 1, HEAD_REQUESTS)
    requests = [(2 + rng.standard_normal((int(r), D))).astype(np.float32)
                for r in sizes]
    counters = (ck.layernorm_fwd, ck.rmsnorm_fwd, ck.softmax_fwd,
                ck.softmax_xent_fwd)
    batcher = DynamicBatcher(engine, max_wait_ms=SERVE_WAIT_MS).start()
    try:
        # the main path: counts are zeroed just before and read just after
        for fwd in counters:
            fwd.launches = 0
        before = {fwd: dict(fwd.launches_by_body)
                  for fwd in (ck.layernorm_fwd, ck.softmax_fwd)}
        answers, wall = _burst(
            DECODER_THREADS, list(range(len(requests))),
            lambda i: batcher.predict(requests[i], timeout=300)[0])
        launches = {fwd.__name__: fwd.launches for fwd in counters}
        bodies = {fwd.__name__: sorted(bodies_ran(fwd, b))
                  for fwd, b in before.items()}
    finally:
        batcher.close()
    n_disp = len(batcher.dispatch_log)
    want = {'layernorm_fwd': n_disp, 'rmsnorm_fwd': 0, 'softmax_fwd': n_disp,
            'softmax_xent_fwd': 0}
    if not on_card:
        want = dict.fromkeys(want, 0)
    log('  Module(LayerNorm -> FullyConnected to %d, no bias -> softmax) from '
        'its checkpoint, per example (%d,) f32, max_batch %d: %d requests of '
        '%s rows from %d threads in %d dispatches; launches %s, on the '
        'bodies %s'
        % (V, D, HEAD_MAX_BATCH, len(requests), sizes.tolist(),
           DECODER_THREADS, n_disp, launches, bodies))
    check(launches == want, 'head launches %s != %s' % (launches, want))
    lat = [sec * 1e3 for _, _, sec in answers]
    log('    request latency (host clock): p50 %.2f ms, p99 %.2f ms'
        % (_pct(lat, 50), _pct(lat, 99)))
    _batcher_line(batcher, wall, 1, 'rows')
    p = {k: torch.from_numpy(v.astype(np.float32)).to(device)
         for k, v in params.items()}
    worst = 0.0
    with torch.inference_mode():
        for i, got, _ in answers:
            x = torch.from_numpy(requests[i]).to(device)
            h = ck.layernorm_ref(x, p['ln_gamma'], p['ln_beta'], eps=1e-5)
            plain = ck.softmax_ref(h @ p['head_weight'].t()).cpu().numpy()
            check(got.shape == plain.shape and np.isfinite(got).all(),
                  'head answer %d has shape %s' % (i, got.shape))
            worst = max(worst, float(np.abs(got - plain).max()))
    log('    probabilities against the plain versions: max abs error %.3e '
        '(held to %g)' % (worst, HEAD_ATOL))
    check(worst <= HEAD_ATOL, 'served head disagrees with the plain versions')
    return launches


def phase_n(device, cfg, model, ref, ckpt, spec=RESNET):
    """Phase (n): the serving plane on the card. (n1) (l1)'s ResNet-50
    checkpoint over HTTP, (n2) bench's decoder behind the batcher, (n3) the
    decoder's head as a served Module, all with the port's telemetry on.
    Returns (K1's launches, {row wrapper: launches})."""
    t0 = time.perf_counter()
    work = os.path.dirname(ckpt)
    log('  (n1) train_imagenet\'s fitted %s from its checkpoint (epoch 1) '
        'over HTTP' % spec[0])
    serve_resnet(device, ckpt, 1, spec)
    log('  (n1) the same net\'s logits from its initial checkpoint (epoch '
        '0) over HTTP')
    _logits_checkpoint(ckpt, 0, ckpt + '-logits')
    spread = serve_resnet(device, ckpt + '-logits', 0, spec, logits=True)
    check(spread > 10 * SERVE_RESNET_REL_RMS,
          'the initial net answers two images alike (%.3e apart)' % spread)
    with _telemetry_on(os.path.join(work, 'serve-telemetry.jsonl')):
        log('  (n2) bench\'s decoder behind the batcher')
        flash = serve_decoder(device, cfg, model, ref)
        log('  (n3) the decoder\'s head as a served Module')
        rows = serve_head(device, cfg, work)
    log('  phase (n) took %.1f s' % (time.perf_counter() - t0))
    return flash, rows


def phase_m(device, cfg, spec=RESNET, per_batch=None):
    """Phase (m): (m1) the windowed Module.fit, score and predict on bench's
    ResNet-50, (m2) the kernels through the windows. Returns (m2)'s
    launches and (m1)'s times."""
    t0 = time.perf_counter()
    log('  (m1) train_imagenet\'s recipe through the windowed Module.fit: '
        '%s, batch %d' % (spec[0], spec[1]))
    windowed = window_fit(device, spec, per_batch)
    log('  (m2) the kernels through the fit and score windows')
    launches = window_kernels(device, cfg)
    log('  phase (m) took %.1f s' % (time.perf_counter() - t0))
    return launches, windowed


def phase_l(device, cfg, spec=RESNET, n_images=FIT_IMAGES, ckpt=None):
    """Phase (l): (l1) Module.fit on bench's ResNet-50 (its checkpoints
    saved at the prefix ``ckpt``: epoch 0 initial, epoch 1 fitted), (l2) the
    kernels through Module,
    both through the per-batch loop, (l3) the Gluon loop. Returns (l2)'s
    launches and (l1)'s times."""
    log('  (l1) train_imagenet\'s recipe through Module.fit: %s, batch %d'
        % (spec[0], spec[1]))
    # (l1) and (l2) stay the per-batch reference: the windows are (m)'s
    with _per_batch():
        fitted = module_fit(device, spec, n_images, ckpt)
        log('  (l2) the kernels through Module.fit and Module.score')
        launches = module_kernels(device, cfg)
    log('  (l3) the Gluon loop: autograd.record, a loss, Trainer.step')
    gluon_loop(device, fitted, spec)
    return launches, {k: fitted[k] for k in ('batch_ms', 'wall_ms', 'speed')}


def phase_k(device, cfg, spec=RESNET):
    """Phase (k): (k1) bench's ResNet-50 step, (k2) the executor and (k3)
    autograd reaching the row kernels. Returns ((k2)'s launches, (k3)'s,
    what (k1)'s times need)."""
    log('  (k1) bench\'s %s step at batch %d x %d x %d' % (
        spec[0], spec[1], spec[2], spec[2]))
    resnet = resnet_step(device, spec)
    log('  (k2) the executor reaches the kernels')
    exec_launches = executor_kernels(device, cfg)
    log('  (k3) autograd reaches the kernels')
    ag_launches = autograd_kernels(device, cfg)
    return exec_launches, ag_launches, resnet


# ---------------------------------------------------------------------------
# (o) the rest of the op library and the zoo families: bench's alexnet and
#     inceptionv3 steps, the other families' forwards, the new names at the
#     decoder head's widths (K4, K5) and a broadcast label through K3
# ---------------------------------------------------------------------------

# bench's other two image configurations (bench.py:34-41, 297-299, 327-330):
# (zoo name, batch, image side, classes); lr 0.01 for AlexNet, 0.1 else
ALEXNET = ('alexnet', 256, 224, 1000)
INCEPTION = ('inceptionv3', 32, 299, 1000)
ZOO_STEPS = 5
ZOO_TIMED = 5
# What the run holds of the loss over its steps on the fixed batch: finite,
# and falling from step 1 to step 2, as (k1) holds ResNet-50's. AlexNet's
# He-initialised logits start large (a loss near 34-36) and bench's lr 0.01
# with momentum 0.9 overshoots a fixed batch of 32 from step 3 on, in f32
# as in bf16 and in the JAX package's step alike; at batch 256 it fell over
# all five steps on the H100. The losses are printed.
# What step 1 in bf16 holds against the same step in f32 compute on the
# card (the same masters, images, labels and Dropout masks: both runs draw
# from generators seeded by the run's seed 0 and each node's index):
# - the loss: rtol 2e-2, as ResNet-50's (k1);
# - the output layer's gradients (weight and bias): 0.15, as ResNet-50's
#   dense layer's, but for Inception V3's weight: 0.3. Its gradient is the
#   softmax's error times the pooled features, which come through 94
#   BatchNorms in training over bf16 activations (the H100 gave 0.19 where
#   ResNet-50's 53 gave 8.6e-2; its bias, the softmax's error alone,
#   5.7e-3);
# - Inception V3's new BN moving statistics: 3e-2, as ResNet-50's; and its
#   gradients with the graph in prediction (BatchNorm on the moving
#   statistics, well conditioned), every master's bf16 gradient against
#   its f32 one, relative RMS median 0.05 and worst 0.2, as (k1) holds
#   ResNet-50's;
# - every master's gradient: relative RMS error median 0.2 and worst 0.5,
#   a gradient lost or off by a fifth on most masters failing. AlexNet has
#   no BatchNorm, but its He-initialised logits start large and saturate
#   the softmax, so bf16's rounding of the logits (2**-8 relative) moves
#   the weights of the leading classes and every gradient with them, as in
#   (k1)'s prediction: on the CPU at batch 32 its median was 7.6e-2 and its
#   worst 0.24 (the first convolution's weight, the end of the longest
#   backward). Inception V3's gradients in training, BatchNorm over the
#   batch, are printed beside them, and held by the same bound only for
#   AlexNet.
ZOO_LOSS_RTOL = 2e-2
ZOO_HEAD_REL_RMS = 0.15
INCEPTION_HEAD_WEIGHT_REL_RMS = 0.3
ZOO_STAT_REL_RMS = 3e-2
ALEXNET_GRAD_REL_RMS = (0.2, 0.5)
# (o3): the families that bench does not time, one forward each in f32
ZOO_FORWARDS = ('vgg16_bn', 'densenet121', 'squeezenet1.1')
ZOO_FORWARD_BATCH = 8
# (o4): the decoder head through the new names: x [8192, 1024] bf16 ->
# nd.LayerNorm (K4) -> f32 -> nd.dot with W [1024, 16384] -> nd.softmax
# (K5) -> nd.topk(k=5, ret_typ='both'). The probabilities against the
# plain versions from the same x: 1e-5 absolute, as (n3) holds them; the
# dot on HEAD_SAMPLE rows against float64 on the host: relative RMS 1e-5
# (f32 sums of 1,024 products, TF32 off); topk against a stable host sort
# of the same probabilities, exactly.
HEAD_ROWS = 8192
HEAD_SAMPLE = 64
HEAD_TOPK = 5
DOT_REL_RMS = 1e-5
# batch_dot at [64, 1024, 128] x [64, 1024, 128]^T bf16 against the f32
# product of the same inputs: relative RMS 3e-3 (the output rounded to
# bf16 once, 2**-9 relative at most)
BATCH_DOT_SHAPE = (64, 1024, 128)
BATCH_DOT_REL_RMS = 3e-3
# the linalg_* family on 64 f32 matrices of 128 x 128 against float64 on
# the host: products relative RMS 1e-5, factorizations and solves 1e-4
LINALG_BATCH, LINALG_N = 64, 128
LINALG_PRODUCT_RTOL = 1e-5
LINALG_FACTOR_RTOL = 1e-4
# the regression heads' and SVMOutput's gradients under autograd.record()
# against the same on the CPU: 1e-6 relative RMS (elementwise rules)
HEAD_GRAD_REL_RMS = 1e-6
XENT_RTOL = 1e-5


def zoo_step(device, spec):
    """Phase (o1)/(o2): bench's step of ``spec`` (graph_train.make_train_step
    at bench's lr for the model) for ZOO_STEPS steps, finite and falling;
    step 1 against the same step in f32 with the same Dropout masks; the
    step's times and torch.profiler's kernels a step and idle share."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import graph_train
    name, batch, image, classes = spec
    t0 = time.perf_counter()
    with mt.name.NameManager():
        step, masters0, aux0, vel0, images, labels, prog = \
            graph_train.make_train_step(name, batch, image, classes, device)
    n_params = sum(m.numel() for n, m in zip(prog.arg_names, masters0)
                   if n != 'data')
    log('  %s: %d graph ops, %d masters (%d f32 parameters), %d aux states; '
        'batch %s bf16 and labels from seed 0; lr %g; built in %.1f s'
        % (name, len(prog.op_nodes), len(masters0) - 1, n_params, len(aux0),
           tuple(images.shape), graph_train.bench_lr(name),
           time.perf_counter() - t0))
    masters, aux, vel, losses = masters0, aux0, vel0, []
    for _ in range(ZOO_STEPS):
        masters, aux, vel, loss = step(masters, aux, vel, images, labels)
        losses.append(float(loss))
    finite = all(bool(torch.isfinite(t).all()) for t in masters + aux + vel)
    del masters, aux, vel
    log('  %d steps: losses %s; masters, velocities and aux states %s'
        % (ZOO_STEPS, ['%.6f' % x for x in losses],
           'finite' if finite else 'NOT FINITE'))
    check(finite and all(np.isfinite(losses)), 'the step is not finite')
    check(losses[1] < losses[0], 'the loss did not fall from step 1 to '
          'step 2: %s' % losses)

    runner = prog.make_runner()
    loss16, g16, aux16 = graph_train.loss_and_grads(
        runner, prog, masters0, aux0, images, labels, torch.bfloat16, seed=0)
    loss32, g32, aux32 = graph_train.loss_and_grads(
        runner, prog, masters0, aux0, images.float(), labels, torch.float32,
        seed=0)
    grad_err = {n: rel_rms(a, b) for n, a, b in zip(prog.arg_names, g16, g32)
                if n != 'data'}
    worst = max(grad_err, key=grad_err.get)
    median = statistics.median(grad_err.values())
    loss_err = abs(float(loss16) - float(loss32)) / abs(float(loss32))
    # the output layer: the layer of the graph's last argument (its bias)
    head = {n: e for n, e in grad_err.items() if n.startswith(
        prog.arg_names[-1].rsplit('_', 1)[0])}
    stat_err = max((rel_rms(a, b) for a, b in zip(aux16, aux32)), default=0.0)
    log('  step 1, bf16 against f32 compute (the same Dropout masks): loss '
        '%.6f / %.6f (relative error %.3e); the %d masters\' gradients, '
        'relative RMS error median %.3e, worst %.3e (%s); the output layer\'s '
        '%s; new BN statistics, worst %.3e'
        % (float(loss16), float(loss32), loss_err, len(grad_err), median,
           grad_err[worst], worst,
           ', '.join('%s %.3e' % kv for kv in head.items()), stat_err))
    check(loss_err <= ZOO_LOSS_RTOL, 'step 1\'s loss disagrees with f32')
    head_tol = {n: INCEPTION_HEAD_WEIGHT_REL_RMS
                if aux0 and n.endswith('_weight') else ZOO_HEAD_REL_RMS
                for n in head}
    check(all(e <= head_tol[n] for n, e in head.items()),
          'step 1\'s output-layer gradients disagree with f32')
    if aux0:
        check(stat_err <= ZOO_STAT_REL_RMS,
              'step 1\'s new BN statistics disagree with f32')
        pred = [graph_train.loss_and_grads(
            runner, prog, masters0, aux0, im, labels, dt, seed=0,
            is_train=False)[1] for im, dt in ((images, torch.bfloat16),
                                              (images.float(), torch.float32))]
        pred_err = {n: rel_rms(a, b) for n, a, b in zip(prog.arg_names, *pred)
                    if n != 'data'}
        worst_p = max(pred_err, key=pred_err.get)
        median_p = statistics.median(pred_err.values())
        log('  step 1 in prediction, bf16 against f32 compute: the %d '
            'masters\' gradients, relative RMS error median %.3e, worst %.3e '
            '(%s), held to %s' % (len(pred_err), median_p, pred_err[worst_p],
                                  worst_p, RESNET_PREDICT_REL_RMS))
        check(median_p <= RESNET_PREDICT_REL_RMS[0]
              and pred_err[worst_p] <= RESNET_PREDICT_REL_RMS[1],
              'step 1\'s gradients in prediction disagree with f32')
        del pred
    else:
        check(median <= ALEXNET_GRAD_REL_RMS[0]
              and grad_err[worst] <= ALEXNET_GRAD_REL_RMS[1],
              'step 1\'s gradients disagree with f32')
    del g16, g32, aux16, aux32
    if device.type != 'cuda':
        return

    def one():
        return step(masters0, aux0, vel0, images, labels)
    step_ms = device_ms(one, runs=ZOO_TIMED, warmup=1)
    torch.cuda.synchronize()
    walls = []
    for _ in range(ZOO_TIMED):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    log('  step, batch %d x 3 x %d x %d: %.3f ms by CUDA events (%.1f '
        'images/s); host wall time %.3f ms (%.1f images/s)'
        % (batch, image, image, step_ms, batch / step_ms * 1e3, wall_ms,
           batch / wall_ms * 1e3))
    profile_steps(one, set(prog.scope_names))


def zoo_forwards(device):
    """Phase (o3): one forward of each family bench does not time, at batch
    ZOO_FORWARD_BATCH x 224 in f32, hybridized against imperative."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon.model_zoo import vision
    ctx = mt.gpu(device.index or 0) if device.type == 'cuda' else mt.cpu()
    gen = torch.Generator(device=device).manual_seed(5)
    x = nd.from_torch(torch.randn(ZOO_FORWARD_BATCH, 3, 224, 224,
                                  generator=gen, device=device), ctx)
    for name in ZOO_FORWARDS:
        with mt.name.NameManager():
            net = vision.get_model(name, classes=1000)
        net.initialize(ctx=ctx)
        imperative = net(x).handle.detach().clone()
        net.hybridize()
        hybrid = net(x).handle
        err = rel_rms(hybrid, imperative)
        ok = (tuple(hybrid.shape) == (ZOO_FORWARD_BATCH, 1000)
              and hybrid.device == device
              and bool(torch.isfinite(hybrid).all()))
        log('  %s: logits %s on %s, finite %s; hybridized against '
            'imperative, relative RMS %.3e (held to %g)'
            % (name, tuple(hybrid.shape), hybrid.device, ok, err,
               HYBRID_REL_RMS))
        check(ok and err <= HYBRID_REL_RMS,
              '%s: the hybridized forward disagrees' % name)
        del net, imperative, hybrid


def _zero_counts(counters):
    for fwd in counters:
        fwd.launches = 0


def head_through_new_names(device, cfg):
    """Phase (o4)'s head: nd.LayerNorm (K4) -> nd.dot -> nd.softmax (K5) ->
    nd.topk at the decoder's widths, each held to its reference. Returns
    {wrapper: launches}."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    ctx = mt.gpu(device.index or 0) if device.type == 'cuda' else mt.cpu()
    D, V = cfg.d_model, cfg.vocab
    x, gamma, beta = row_inputs('layernorm', (HEAD_ROWS, D), 'bfloat16',
                                device, seed=21)
    gen = torch.Generator(device=device).manual_seed(22)
    w = torch.randn(D, V, generator=gen, device=device) / math.sqrt(D)
    x_nd, g_nd, b_nd, w_nd = (nd.from_torch(t, ctx)
                              for t in (x, gamma, beta, w))
    counters = [row_fns(k)[0] for k in ROW_KERNELS]
    # the main path: counts are zeroed just before and read just after
    _zero_counts(counters)
    h = nd.LayerNorm(x_nd, g_nd, b_nd, eps=1e-5)
    logits = nd.dot(h.astype('float32'), w_nd)
    probs = nd.softmax(logits)
    top_v, top_i = nd.topk(probs, k=HEAD_TOPK, ret_typ='both')
    top_i.wait_to_read()
    launches = {fwd.__name__: fwd.launches for fwd in counters}
    want = {'layernorm_fwd': 1, 'rmsnorm_fwd': 0, 'softmax_fwd': 1,
            'softmax_xent_fwd': 0}
    if device.type != 'cuda':
        want = dict.fromkeys(want, 0)
    log('  LayerNorm [%d, %d] bf16 -> f32 -> dot [%d, %d] f32 -> softmax -> '
        'topk(k=%d, both): launches %s'
        % (HEAD_ROWS, D, D, V, HEAD_TOPK, launches))
    check(launches == want, 'head launches %s != %s' % (launches, want))

    with torch.no_grad():
        h_ref = ck.layernorm_ref(x, gamma, beta, eps=1e-5)
        p_ref = ck.softmax_ref(h_ref.float() @ w)
    prob_err = float((probs.handle - p_ref).abs().max())
    rows = torch.randperm(HEAD_ROWS, generator=torch.Generator().manual_seed(
        23))[:HEAD_SAMPLE].to(device)
    exact = (h.handle.float()[rows].double().cpu()
             @ w.double().cpu())
    dot_err = rel_rms(logits.handle[rows].cpu(), exact)
    host = probs.handle[rows].cpu().numpy()
    order = np.argsort(-host, axis=-1, kind='stable')[:, :HEAD_TOPK]
    top_ok = (np.array_equal(top_i.handle[rows].cpu().numpy(),
                             order.astype(np.float32))
              and np.array_equal(top_v.handle[rows].cpu().numpy(),
                                 np.take_along_axis(host, order, -1)))
    log('    probabilities against the plain versions: max abs error %.3e '
        '(held to %g); the dot on %d rows against float64 on the host: '
        'relative RMS %.3e (held to %g); topk against a stable host sort: %s'
        % (prob_err, HEAD_ATOL, HEAD_SAMPLE, dot_err, DOT_REL_RMS,
           'exact' if top_ok else 'DIFFERENT'))
    check(bool(torch.isfinite(probs.handle).all()) and prob_err <= HEAD_ATOL,
          'the head disagrees with the plain versions')
    check(dot_err <= DOT_REL_RMS, 'nd.dot disagrees with float64')
    check(top_ok, 'nd.topk disagrees with a host sort')
    if device.type == 'cuda':
        a, b = h.astype('float32'), w_nd
        ms = device_ms(lambda: nd.dot(a, b), runs=10)
        flops = 2.0 * HEAD_ROWS * D * V
        log('    nd.dot f32 [%d, %d] x [%d, %d]: %.4f ms, %.1f TFLOP/s (f32 '
            'peak %.0f)' % (HEAD_ROWS, D, D, V, ms, flops / ms / 1e9,
                           F32_FLOPS / 1e12))
        ms = device_ms(lambda: nd.topk(probs, k=HEAD_TOPK, ret_typ='both'),
                       runs=5)
        log('    nd.topk(k=%d) over [%d, %d] f32: %.4f ms'
            % (HEAD_TOPK, HEAD_ROWS, V, ms))
    return launches


def ordering_rows(device):
    """sort, argsort and topk on rows with ties, NaN of both signs, the
    infinities and both zeros, against the same ops on the CPU: bit for
    bit, NaN where NaN."""
    import torch
    from mxnet_tpu_torch.ops.registry import get as get_op
    rng = np.random.RandomState(24)
    base = np.round(rng.standard_normal((64, 4096)), 1).astype(np.float32)
    base[:, ::97] = np.nan
    base[:, 5::101] = -np.nan
    base[:, 7::103] = np.inf
    base[:, 9::107] = -np.inf
    base[:, 11::109] = -0.0
    arrays = {'float32': torch.from_numpy(base),
              'bfloat16': torch.from_numpy(base).to(torch.bfloat16),
              'int32': torch.from_numpy(rng.randint(-20, 20, base.shape,
                                                    dtype=np.int32))}
    cases = [('sort', {'is_ascend': asc, 'axis': ax})
             for asc in (True, False) for ax in (-1, 0, None)]
    cases += [('argsort', {'is_ascend': asc, 'axis': ax})
              for asc in (True, False) for ax in (-1, None)]
    cases += [('topk', {'k': 9, 'ret_typ': r, 'is_ascend': asc})
              for r in ('indices', 'value', 'mask', 'both')
              for asc in (True, False)]
    bad = []
    for dtype, host in arrays.items():
        card = host.to(device)
        for name, attrs in cases:
            op = get_op(name).fn
            got, want = op(attrs, card), op(attrs, host)
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                g = g.cpu()
                nan = torch.isnan(w) if w.is_floating_point() else None
                same = g.shape == w.shape and g.dtype == w.dtype
                if same and nan is not None:
                    same = (torch.equal(torch.isnan(g), nan)
                            and torch.equal(g[~nan], w[~nan])
                            and torch.equal(torch.signbit(g[~nan]),
                                            torch.signbit(w[~nan])))
                elif same:
                    same = torch.equal(g, w)
                if not same:
                    bad.append('%s %s %s' % (name, attrs, dtype))
    log('    sort, argsort and topk: %d cases on [64, 4096] rows in f32, bf16 '
        'and int32 (ties, NaN of both signs, infinities, -0) against the '
        'CPU: %s' % (len(cases) * len(arrays), 'all exact' if not bad
                     else 'DIFFERENT: %s' % bad))
    check(not bad, 'orderings differ from the CPU: %s' % bad)


def linalg_family(device):
    """The linalg_* family on LINALG_BATCH f32 matrices of LINALG_N x
    LINALG_N against float64 on the host; gelqf by L Q = A, Q Q^T = I and
    L lower triangular (cuSOLVER's signs may differ from LAPACK's)."""
    import torch
    from mxnet_tpu_torch.ops.registry import get as get_op
    B, n = LINALG_BATCH, LINALG_N
    rng = np.random.RandomState(25)
    m = rng.standard_normal((B, n, n))
    spd = m @ m.transpose(0, 2, 1) + n * np.eye(n)
    low = np.tril(rng.standard_normal((B, n, n)), -1) / np.sqrt(n) \
        + np.eye(n) * (1 + rng.uniform(0, 1, (B, 1, n)))
    a, b, c = (rng.standard_normal((B, n, n)) for _ in range(3))
    wide = rng.standard_normal((B, n // 2, n))

    def run(name, attrs, *arrays):
        return get_op(name).fn(attrs, *(torch.from_numpy(x.astype(
            np.float32)).to(device) for x in arrays))

    def err(got, want):
        got = got.double().cpu().numpy()
        return float(np.sqrt(np.mean((got - want) ** 2))
                     / np.sqrt(np.mean(want ** 2)))
    L = np.linalg.cholesky(spd)
    inv_low = np.linalg.inv(low)
    checks = [
        ('gemm', LINALG_PRODUCT_RTOL, err(run(
            'linalg_gemm', {'transpose_a': True, 'alpha': 0.5, 'beta': 2.0},
            a, b, c), 0.5 * a.transpose(0, 2, 1) @ b + 2 * c)),
        ('gemm2', LINALG_PRODUCT_RTOL, err(run(
            'linalg_gemm2', {'transpose_b': True}, a, b),
            a @ b.transpose(0, 2, 1))),
        ('syrk', LINALG_PRODUCT_RTOL, err(run('linalg_syrk', {}, a),
                                          a @ a.transpose(0, 2, 1))),
        ('trmm', LINALG_PRODUCT_RTOL, err(run(
            'linalg_trmm', {'rightside': True}, low, b), b @ low)),
        ('potrf', LINALG_FACTOR_RTOL, err(run('linalg_potrf', {}, spd), L)),
        ('potri', LINALG_FACTOR_RTOL, err(run('linalg_potri', {}, low),
                                          inv_low.transpose(0, 2, 1)
                                          @ inv_low)),
        ('trsm', LINALG_FACTOR_RTOL, err(run(
            'linalg_trsm', {'transpose': True, 'alpha': 2.0}, low, b),
            2 * np.linalg.solve(low.transpose(0, 2, 1), b))),
        ('sumlogdiag', LINALG_FACTOR_RTOL, err(run(
            'linalg_sumlogdiag', {}, spd),
            np.log(np.diagonal(spd, axis1=1, axis2=2)).sum(-1))),
    ]
    q, lo = run('linalg_gelqf', {}, wide)
    q, lo = q.double().cpu().numpy(), lo.double().cpu().numpy()
    eye = np.broadcast_to(np.eye(n // 2), (B, n // 2, n // 2))
    checks += [('gelqf L Q = A', LINALG_FACTOR_RTOL, float(
                   np.sqrt(np.mean((lo @ q - wide) ** 2))
                   / np.sqrt(np.mean(wide ** 2)))),
               ('gelqf Q Q^T = I', LINALG_FACTOR_RTOL, float(
                   np.sqrt(np.mean((q @ q.transpose(0, 2, 1) - eye) ** 2)))),
               ('gelqf L lower', 0.0, float(np.abs(np.triu(lo, 1)).max()))]
    log('    linalg_* on %d f32 matrices of %d x %d against float64 on the '
        'host, relative RMS: %s' % (B, n, n, ', '.join(
            '%s %.3e (held to %g)' % (name, e, tol)
            for name, tol, e in checks)))
    for name, tol, e in checks:
        check(e <= tol, 'linalg %s: %.3e > %g' % (name, e, tol))


def heads_gradients(device):
    """The regression heads' and SVMOutput's gradients under
    autograd.record() on the card against the same on the CPU."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, nd
    rng = np.random.RandomState(26)
    data = rng.standard_normal((256, 1000)).astype(np.float32)
    target = rng.standard_normal((256, 1000)).astype(np.float32)
    label = rng.randint(0, 1000, 256).astype(np.float32)
    heads = [('LinearRegressionOutput', target, {'grad_scale': 2.0}),
             ('LogisticRegressionOutput', (target > 0).astype(np.float32),
              {}),
             ('MAERegressionOutput', target, {'grad_scale': 0.5}),
             ('SVMOutput', label, {'margin': 0.5}),
             ('SVMOutput', label, {'use_linear': True})]
    worst = 0.0
    for name, lab, attrs in heads:
        grads = []
        for ctx in (mt.gpu(device.index or 0) if device.type == 'cuda'
                    else mt.cpu(), mt.cpu()):
            x = nd.array(data, ctx=ctx)
            x.attach_grad()
            with autograd.record():
                out = getattr(nd, name)(x, nd.array(lab, ctx=ctx), **attrs)
            out.backward()
            grads.append(x.grad.handle.cpu())
        e = rel_rms(grads[0], grads[1])
        check(bool(torch.isfinite(grads[0]).all()) and
              grads[0].abs().sum() > 0 and e <= HEAD_GRAD_REL_RMS,
              '%s %s: the gradient on the card differs from the CPU\'s '
              '(%.3e)' % (name, attrs, e))
        worst = max(worst, e)
    log('    the regression heads\' and SVMOutput\'s gradients under '
        'autograd.record() on [256, 1000]: worst relative RMS against the '
        'CPU %.3e (held to %g)' % (worst, HEAD_GRAD_REL_RMS))


def xent_one_label(device, cfg):
    """Phase (o5): nd.softmax_cross_entropy at [8192, 16384] f32 with a
    (1,) label through K3 (counted), against the plain version with the
    label broadcast; a (3,) label raises ValueError before any launch.
    Returns {wrapper: launches}."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    ctx = mt.gpu(device.index or 0) if device.type == 'cuda' else mt.cpu()
    N, V = HEAD_ROWS, cfg.vocab
    logits, _ = row_inputs('softmax_xent', (N, V), 'float32', device, seed=27)
    x = nd.from_torch(logits, ctx)
    counters = [row_fns(k)[0] for k in ROW_KERNELS]
    # the main path: counts are zeroed just before and read just after
    _zero_counts(counters)
    loss = nd.softmax_cross_entropy(x, nd.array([3], ctx=ctx))
    got = float(loss.asscalar())
    try:
        nd.softmax_cross_entropy(x, nd.array([3, 1, 2], ctx=ctx))
        raised = False
    except ValueError:
        raised = True
    launches = {fwd.__name__: fwd.launches for fwd in counters}
    want = {'layernorm_fwd': 0, 'rmsnorm_fwd': 0, 'softmax_fwd': 0,
            'softmax_xent_fwd': int(device.type == 'cuda')}
    plain = float(ck.softmax_xent_ref(logits, torch.full(
        (N,), 3, dtype=torch.int32, device=device)).sum())
    err = abs(got - plain) / abs(plain)
    log('  softmax_cross_entropy [%d, %d] f32 with a (1,) label: %.6f, the '
        'plain version with the label broadcast %.6f (relative error %.3e, '
        'held to %g); a (3,) label raises ValueError: %s; launches %s'
        % (N, V, got, plain, err, XENT_RTOL, raised, launches))
    check(raised, 'a (3,) label did not raise')
    check(launches == want, 'launches %s != %s' % (launches, want))
    check(err <= XENT_RTOL, 'the broadcast label disagrees with the plain '
          'version')
    return launches


def batch_dot_check(device):
    """nd.batch_dot at BATCH_DOT_SHAPE x its transpose in bf16 against the
    f32 product of the same inputs."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import nd
    ctx = mt.gpu(device.index or 0) if device.type == 'cuda' else mt.cpu()
    gen = torch.Generator(device=device).manual_seed(28)
    a, b = (torch.randn(BATCH_DOT_SHAPE, generator=gen, device=device).to(
        torch.bfloat16) for _ in range(2))
    got = nd.batch_dot(nd.from_torch(a, ctx), nd.from_torch(b, ctx),
                       transpose_b=True).handle
    err = rel_rms(got, a.float() @ b.float().transpose(1, 2))
    log('    batch_dot %s x %s^T bf16: %s %s, relative RMS against the f32 '
        'product %.3e (held to %g)' % (BATCH_DOT_SHAPE, BATCH_DOT_SHAPE,
                                       tuple(got.shape), got.dtype, err,
                                       BATCH_DOT_REL_RMS))
    check(got.dtype == torch.bfloat16 and err <= BATCH_DOT_REL_RMS,
          'batch_dot disagrees with the f32 product')


def phase_o(device, cfg):
    """Phase (o): (o1) bench's AlexNet step, (o2) its Inception V3 step, (o3)
    the other families' forwards, (o4) the new names at the decoder head's
    widths, (o5) a broadcast label through K3. Returns {row wrapper:
    launches} of (o4) and (o5) together."""
    import torch
    t0 = time.perf_counter()
    for spec in (ALEXNET, INCEPTION):
        log('  (o%d) bench\'s %s step at batch %d x %d x %d'
            % ((1 if spec is ALEXNET else 2), spec[0], spec[1], spec[2],
               spec[2]))
        zoo_step(device, spec)
        torch.cuda.empty_cache()
    log('  (o3) the other families: %s' % ', '.join(ZOO_FORWARDS))
    zoo_forwards(device)
    log('  (o4) the new names at the decoder head\'s widths')
    launches = head_through_new_names(device, cfg)
    batch_dot_check(device)
    ordering_rows(device)
    linalg_family(device)
    heads_gradients(device)
    log('  (o5) a (1,) label through the softmax_xent kernel')
    for k, v in xent_one_label(device, cfg).items():
        launches[k] += v
    log('  phase (o) took %.1f s' % (time.perf_counter() - t0))
    return launches


# ---------------------------------------------------------------------------
# (p) the training loop's telemetry and the profiler on the card
# ---------------------------------------------------------------------------

TELE_FIT_BATCHES = 8    # (p1): train_imagenet's recipe, 8 batches of 32
# (p1) holds every run's final parameters and aux states to the first run's
# (telemetry off) bit for bit, under cuDNN's deterministic algorithms (as
# (m1)): the spans read host clocks and add no synchronisation and no
# device work. The goodput record rounds its wall and each of its eight
# buckets to 1 ms, so their sum is the wall within 5 ms.
GOODPUT_SUM_S = 0.005
TELE_LEAVES = {
    'per-batch': ('fit.dispatch', 'fit.draw', 'fit.metric', 'fit.callback',
                  'exec_group.forward', 'exec_group.backward',
                  'executor.forward', 'executor.backward', 'module.update'),
    'window': ('fused_fit.build', 'fused_fit.draw', 'fused_fit.put',
               'fused_fit.dispatch', 'fused_fit.fetch')}
# (p2): the host spans profile.json must hold, and the kernels its device
# trace must name (by the name their template instances begin with), with
# the row kernel each is the body of
PROFILE_SPANS = ('fit.batch', 'fit.dispatch', 'fit.draw', 'fit.metric',
                 'fit.callback', 'eval.dispatch', 'eval.metric',
                 'exec_group.forward', 'exec_group.backward',
                 'executor.forward', 'executor.backward', 'module.update')
PROFILE_KERNELS = {'layernorm_rows_kernel': 'layernorm',
                   'xent_kernel': 'softmax_xent'}


def _jsonl(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def trace_kernels(trace_dir):
    """{kernel name without its namespaces, template arguments and
    parameters: [launches, device ms]} from the 'kernel' events of the one
    chrome trace in ``trace_dir`` (the row kernels are in an anonymous
    namespace: 'void (anonymous namespace)::xent_kernel<float, int>(...)'
    is 'xent_kernel')."""
    files = [f for f in os.listdir(trace_dir) if f.endswith('.json')]
    check(len(files) == 1, 'the device trace in %s holds %s'
          % (trace_dir, files))
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)['traceEvents']
    out = {}
    for e in events:
        if e.get('cat') != 'kernel':
            continue
        name = e['name'].replace('(anonymous namespace)::', '')
        name = name[5:] if name.startswith('void ') else name
        base = name.split('<')[0].split('(')[0].strip().rsplit('::', 1)[-1]
        got = out.setdefault(base, [0, 0.0])
        got[0] += 1
        got[1] += float(e.get('dur', 0.0)) / 1e3
    return out


def trace_gaps(trace_dir, kname):
    """Print where a device trace lost kernels: the kernel launches (the
    runtime's launch events) whose correlation id has no kernel event, by
    their host time from the trace's first event, beside ``kname``'s
    kernel events."""
    files = [f for f in os.listdir(trace_dir) if f.endswith('.json')]
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)['traceEvents']
    t0 = min(e['ts'] for e in events if 'ts' in e)
    kernels = {e.get('args', {}).get('correlation') for e in events
               if e.get('cat') == 'kernel'}
    launches = [e for e in events if e.get('cat') in ('cuda_runtime',
                                                       'cuda_driver')
                and 'Launch' in e.get('name', '')]
    lost = [(e['name'], round(e['ts'] - t0, 1),
             e.get('args', {}).get('correlation')) for e in launches
            if e.get('args', {}).get('correlation') not in kernels]
    mine = [round(e['ts'] - t0, 1) for e in events
            if e.get('cat') == 'kernel' and kname in e['name']]
    log('  trace gaps: %d launches, %d without a kernel event: %s; %s at %s; '
        'kernel events from %.1f to %.1f us'
        % (len(launches), len(lost), lost[:8], kname, mine,
           min(e['ts'] for e in events if e.get('cat') == 'kernel') - t0,
           max(e['ts'] for e in events if e.get('cat') == 'kernel') - t0))


def check_telemetry_records(loop, path, n_batches, show):
    """The JSONL log of one (p1) fit with telemetry on: the loop's leaf
    spans, its counters and gauges, the goodput record's sum and the
    timeline record's phases; with ``show`` its goodput, timeline and span
    means are printed."""
    recs = _jsonl(path)
    spans = {r['name'] for r in recs if r['type'] == 'span'}
    missing = [s_ for s_ in TELE_LEAVES[loop] if s_ not in spans]
    check(not missing, 'the %s loop logged no %s' % (loop, missing))
    summ = [r for r in recs if r['type'] == 'summary'][-1]
    counters = summ['snapshot']['counters']
    gauges = summ['snapshot']['gauges']
    want = {'fit.steps': n_batches}
    if loop == 'window':
        want['fused_fit.windows'] = n_batches // 4
    got = {k: counters.get(k) for k in want}
    check(got == want, 'counters %s, not %s' % (got, want))
    if loop == 'window':
        check(gauges.get('fused_fit.steps_per_call') == 4,
              'fused_fit.steps_per_call is %s'
              % gauges.get('fused_fit.steps_per_call'))
    check(gauges.get('speedometer.samples_per_sec', 0) > 0,
          'the Speedometer set no gauge')
    good = [r for r in recs if r['type'] == 'goodput'][-1]
    b = good['buckets']
    err = abs(sum(b.values()) - good['wall_s'])
    check(err <= GOODPUT_SUM_S and b['step'] > 0,
          'the goodput record does not sum to its wall (%.4f s off)' % err)
    tl = [r for r in recs if r['type'] == 'timeline'][-1]
    row = tl['per_host'][0]
    ph = row['phases']
    check(all(ph[p] is not None for p in ('draw', 'put', 'dispatch',
                                          'fetch')),
          'the timeline record lacks a phase')
    n_spans = sum(h['count'] for h in summ['snapshot']['histograms'].values())
    if not show:
        return n_spans
    log('  %s loop, goodput (s): %s of wall %.3f; buckets and overhead %.4f '
        'from the wall (held to %g); goodput %.2f%%, top badput %s'
        % (loop, ', '.join('%s %.3f' % kv for kv in b.items()),
           good['wall_s'], err, GOODPUT_SUM_S, good['goodput_pct'],
           good['badput_top']))
    log('  %s loop, step timeline: %.3f ms a step: draw %s, put %s, '
        'dispatch %s, fetch %s ms a step; compute %.3f, io %.3f, host-side '
        '%.3f ms; largest phase %s'
        % (loop, row['step_time_ms'], ph['draw'], ph['put'], ph['dispatch'],
           ph['fetch'], row['compute_ms'], row['io_ms'], row['host_ms'],
           tl.get('critical_phase')))
    hists = summ['snapshot']['histograms']
    log('  %s loop, span means (ms): %s'
        % (loop, ', '.join('%s %.3f' % (n, hists[n]['mean'])
                           for n in TELE_LEAVES[loop])))
    return n_spans


def span_cost_us(work, n=5000):
    """The host us of one telemetry span (a timeline phase's, so that every
    tap runs), with telemetry on (the JSONL sink, the timeline) and off."""
    from mxnet_tpu_torch import telemetry
    out = {}
    for on in (False, True):
        env = dict(MXTPU_TELEMETRY='1', MXTPU_TIMELINE='1',
                   MXTPU_TELEMETRY_PATH=os.path.join(work, 'spans.jsonl')) \
            if on else {}
        with _flags_set(**env):
            telemetry._reset_for_tests()
            check(telemetry.enabled() == on, 'telemetry is not %s'
                  % ('on' if on else 'off'))
            t = time.perf_counter()
            for _ in range(n):
                with telemetry.span('fit.dispatch', 'fit'):
                    pass
            out[on] = (time.perf_counter() - t) * 1e6 / n
            if on:
                telemetry.shutdown()
        telemetry._reset_for_tests()
    return out


def telemetry_fit(device, work, spec=RESNET, n_batches=TELE_FIT_BATCHES):
    """Phase (p1): (l1)'s recipe with the port's telemetry on and off,
    through the per-batch loop and the fused window. Returns {loop: {'on':
    batch ms, 'off': batch ms}}."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import profiler, telemetry
    name, batch, image, classes = spec
    ctx = mt.gpu(device.index or 0)
    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    X = rng.standard_normal((n_batches * batch, 3, image, image)).astype(
        np.float32)
    y = rng.randint(0, classes, n_batches * batch).astype(np.int32)
    train = mt.io.NDArrayIter(X, y, batch_size=batch)
    mod = mt.mod.Module(_zoo_symbol(name, classes, (batch, 3, image, image)))
    mod.bind(train.provide_data, train.provide_label)
    mt.random.seed(0)
    mod.init_params(_xavier())
    args, aux = mod.get_params()
    masters0 = {n: a.handle.detach().clone() for n, a in args.items()}
    aux0 = {n: a.handle.detach().clone() for n, a in aux.items()}
    log('  Module(%s under SoftmaxOutput) on %s, %d batches of %d from seed '
        '0; set up in %.1f s' % (name, mod._context, n_batches, batch,
                                 time.perf_counter() - t0))

    def one_fit(loop, tag, on, xprof=None):
        """(final parameters and aux states, host ms a batch, JSONL path)"""
        mod.set_params({n: mt.nd.from_torch(t.clone(), ctx)
                        for n, t in masters0.items()},
                       {n: mt.nd.from_torch(t.clone(), ctx)
                        for n, t in aux0.items()})
        mod.init_optimizer(kvstore='device', optimizer='sgd',
                           optimizer_params=FIT_OPT, force_init=True)
        train.reset()
        env = {'MXTPU_FUSED_FIT': '1' if loop == 'window' else '0'}
        path = None
        if on:
            path = os.path.join(work, 'p1-%s-%s.jsonl' % (loop, tag))
            env.update(MXTPU_TELEMETRY='1', MXTPU_TELEMETRY_PATH=path,
                       MXTPU_TIMELINE='1')
        if xprof:
            env.update(MXTPU_XPROF='4:8', MXTPU_XPROF_DIR=xprof)
        with _flags_set(**env):
            telemetry._reset_for_tests()
            profiler._xprof_reset_for_tests()
            check(telemetry.enabled() == on, 'telemetry is not %s'
                  % ('on' if on else 'off'))
            mt.random.seed(0)
            _sync(device)
            t = time.perf_counter()
            mod.fit(train, num_epoch=1, optimizer='sgd',
                    optimizer_params=FIT_OPT, eval_metric=['acc'],
                    kvstore='device', batch_end_callback=mt.callback.Speedometer(
                        batch, FIT_SPEEDOMETER))
            _sync(device)
            ms = (time.perf_counter() - t) * 1e3 / n_batches
            if on:
                telemetry.write_summary(log=False)
                telemetry.shutdown()
        telemetry._reset_for_tests()
        profiler._xprof_reset_for_tests()
        a, x = mod.get_params()
        got = {n: v.handle.detach().clone()
               for n, v in list(a.items()) + list(x.items())}
        return got, ms, path

    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    costs = {}
    try:
        for loop in ('per-batch', 'window'):
            xprof = os.path.join(work, 'xprof') if loop == 'window' else None
            one_fit(loop, 'warm-up', False)
            runs = [one_fit(loop, 'off1', False),
                    one_fit(loop, 'on1', True, xprof),
                    one_fit(loop, 'on2', True),
                    one_fit(loop, 'off2', False)]
            first = runs[0][0]
            same = [all(torch.equal(r[0][n], first[n]) for n in first)
                    for r in runs[1:]]
            log('  %s loop: final parameters and aux states against the '
                'first run (telemetry off): telemetry on %s, on again %s, '
                'off again %s (held bit for bit)'
                % (loop, *('bit for bit' if s_ else 'NOT bit for bit'
                           for s_ in same)))
            check(all(same), 'the %s loop\'s parameters differ with '
                  'telemetry on' % loop)
            for run, what in ((runs[1], 'on'), (runs[2], 'on again')):
                # the second run on (no XPROF capture, whose start, stop
                # and export land in the first's wall) is the one printed
                n_spans = check_telemetry_records(loop, run[2], n_batches,
                                                  show=what == 'on again')
            off = statistics.mean([runs[0][1], runs[3][1]])
            on = statistics.mean([runs[1][1], runs[2][1]]) if not xprof \
                else runs[2][1]
            costs[loop] = {'off': off, 'on': on,
                           'spans': n_spans / n_batches}
            log('  %s loop, a batch\'s host ms over the fit (8 batches, '
                'synchronised at the end; after a warm-up fit): telemetry '
                'off %.3f and %.3f, on %.3f and %.3f%s (on %+.2f%% against '
                'off)' % (loop, runs[0][1], runs[3][1], runs[1][1],
                          runs[2][1], ' (the first with the XPROF capture)'
                          if xprof else '', 100 * (on / off - 1)))
            if xprof:
                kern = trace_kernels(xprof)
                n = sum(v[0] for v in kern.values())
                busy = sum(v[1] for v in kern.values())
                log('  MXTPU_XPROF=4:8 device trace (about one window): %d '
                    'kernel events (%d a step of 4), %.3f ms busy a step; '
                    'largest: %s' % (n, n // 4, busy / 4, ', '.join(
                        '%s %.3f ms' % (k, v[1] / 4) for k, v in sorted(
                            kern.items(), key=lambda kv: -kv[1][1])[:3])))
                check(n > 0, 'the XPROF device trace holds no kernel')
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    del mod
    us = span_cost_us(work)
    log('  a telemetry span\'s host cost: %.2f us on (sink, histogram, '
        'timeline tap), %.3f us off; %s'
        % (us[True], us[False], '; '.join(
            '%s loop %.2f spans a batch: %.4f ms a batch'
            % (loop, c['spans'], c['spans'] * us[True] / 1e3)
            for loop, c in costs.items())))
    return costs


def profiled_head(device, cfg, work):
    """Phase (p2): (l2)'s head through the per-batch Module.fit and
    Module.score inside mx.profiler.Profiler. Returns ({row wrapper:
    launches}, {row kernel: device ms a launch from the trace})."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    os.makedirs(os.path.join(work, 'p2'), exist_ok=True)
    path = os.path.join(work, 'p2', 'profile.json')
    warp0 = ck.layernorm_fwd.launches_by_body['warp']
    with _per_batch():
        launches = module_kernels(device, cfg, profile=path)
    grew = {'layernorm': ck.layernorm_fwd.launches_by_body['warp'] - warp0,
            'softmax_xent': launches['softmax_xent_fwd']}
    check(grew['layernorm'] == launches['layernorm_fwd'],
          'LayerNorm ran off its warp body')
    with open(path) as f:
        names = {e['name'] for e in json.load(f)['traceEvents']}
    missing = [s_ for s_ in PROFILE_SPANS if s_ not in names]
    log('  profile.json: %d span names; %s'
        % (len(names), 'every fit.*, eval.*, exec_group.* and executor.* '
           'span asked for' if not missing else 'missing %s' % missing))
    check(not missing, 'profile.json lacks %s' % missing)
    kern = trace_kernels(path[:-len('.json')] + '_cuda')
    # the launches the trace holds no kernel of: at most the capture's
    # markers (profiler._start_capture)
    trace_gaps(path[:-len('.json')] + '_cuda', 'layernorm_rows_kernel')
    per_launch = {}
    for kname, row in PROFILE_KERNELS.items():
        n, ms = kern.get(kname, (0, 0.0))
        log('  device trace: %s %d launches (its counter grew by %d), %.4f '
            'ms a launch' % (kname, n, grew[row], ms / n if n else 0.0))
        check(n == grew[row] and n > 0, '%s: %d in the trace, %d launched'
              % (kname, n, grew[row]))
        per_launch[row] = ms / n
    return launches, per_launch


def phase_p(device, cfg, work):
    """Phase (p): (p1) the training loop's telemetry on (l1)'s recipe, (p2)
    the profiler over (l2)'s head. Returns (p2)'s launches and its trace's
    ms a launch of K3 and K4."""
    t0 = time.perf_counter()
    log('  (p1) train_imagenet\'s recipe with the telemetry on and off, '
        'per batch and in the window')
    telemetry_fit(device, work)
    log('  (p2) mx.profiler over (l2)\'s head through Module.fit and score')
    launches, per_launch = profiled_head(device, cfg, work)
    log('  phase (p) took %.1f s' % (time.perf_counter() - t0))
    return launches, per_launch


# ---------------------------------------------------------------------------
# (q) the data plane on the card
# ---------------------------------------------------------------------------

# (q0): the record file train_imagenet's --data-train reads: 320 images of
# 3 x 256 x 256 uint8 from RandomState(0), labels in [0, 1000), packed as
# '.raw' (the card's machine has no Pillow, which JPEG records need)
RECORD_IMAGES = 320
RECORD_SIDE = 256
# (q1): ImageRecordIter as train_imagenet sets it up, with the means of
# MXNet's example/image-classification/common/data.py, std 1
DATA_MEAN = (123.68, 116.779, 103.939)
RECORD_THREADS = 4
RECORD_SEED = 7         # random.seed() before each run: order, crops, flips
# The device augment against the host augment with the randomness off: the
# same pixels through the same f32 arithmetic, (x * scale - mean) / std
# with one rounding an operation on both sides (the host's table holds the
# same values): 1e-6 relative, bit for bit printed beside it
AUG_RTOL = 1e-6
# (q2): MNISTIter over idx files written from synthetic_mnist, into an MLP
# through Module.fit; gluon.data.vision.MNIST through the DataLoader into a
# Gluon MLP. Chance is 0.1: the fit's accuracy must pass MNIST_ACC
MNIST_IMAGES = 6000
MNIST_BATCH = 100
MNIST_ACC = 0.5
GLUON_MNIST_BATCH = 128
# (q3): (l2)'s head inputs through ArrayDataset and the DataLoader, each
# batch's loss held to the plain versions as (l2) holds it
DATA_HEAD_BATCHES = 3
DATA_HEAD_RTOL = EXEC_LOSS_RTOL


def write_records(rec, idx, n=RECORD_IMAGES, side=RECORD_SIDE, classes=1000):
    """(q0)'s file through the port's MXIndexedRecordIO; returns the packed
    records and the write's seconds."""
    from mxnet_tpu_torch.recordio import IRHeader, MXIndexedRecordIO, pack_img
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (n, 3, side, side)).astype(np.uint8)
    labels = rng.randint(0, classes, n)
    packed = [pack_img(IRHeader(0, float(labels[i]), i, 0), images[i],
                       img_fmt='.raw') for i in range(n)]
    t0 = time.perf_counter()
    w = MXIndexedRecordIO(idx, rec, 'w')
    for i, p in enumerate(packed):
        w.write_idx(i, p)
    w.close()
    return packed, time.perf_counter() - t0


def _read_all(rec):
    from mxnet_tpu_torch.recordio import MXRecordIO
    r = MXRecordIO(rec, 'r')
    out = []
    try:
        while True:
            item = r.read()
            if item is None:
                return out
            out.append(item)
    finally:
        r.close()


def records(work, n=RECORD_IMAGES, side=RECORD_SIDE, classes=1000):
    """Phase (q0): the record file written by the native writer, read back
    through the native and the Python readers byte for byte (sequentially
    and by key through the .idx), and scanned; the MB/s of each. Returns
    the file's path."""
    from mxnet_tpu_torch import _native
    from mxnet_tpu_torch.io.image_record import scan_record_offsets
    from mxnet_tpu_torch.recordio import MXIndexedRecordIO
    rec = os.path.join(work, 'train.rec')
    idx = os.path.join(work, 'train.idx')
    check(_native.backend() == 'native', 'the native record reader did not '
          'load (backend %s)' % _native.backend())
    packed, write_s = write_records(rec, idx, n, side, classes)
    mb = os.path.getsize(rec) / 1e6
    got, secs = {}, {}
    for reader in ('native', 'python'):
        with _flags_set(MXTPU_NO_NATIVE='1' if reader == 'python' else '0'):
            check(_native.backend() == reader, 'the %s reader is not live'
                  % reader)
            t0 = time.perf_counter()
            got[reader] = _read_all(rec)
            secs[reader] = time.perf_counter() - t0
            r = MXIndexedRecordIO(idx, rec, 'r')
            keyed = [r.read_idx(k) for k in (n - 1, 0, n // 2)]
            r.close()
        check(got[reader] == packed and
              keyed == [packed[n - 1], packed[0], packed[n // 2]],
              'the %s reader does not give back the records written' % reader)
    t0 = time.perf_counter()
    offsets = scan_record_offsets(rec)
    scan_s = time.perf_counter() - t0
    check(len(offsets) == n, 'the scan found %d records' % len(offsets))
    log('  %d records (%d x %d x %d uint8 .raw, labels in [0, %d)), %.1f MB: '
        'written by the native writer at %.1f MB/s; read back byte for byte by '
        'the native reader at %.1f MB/s and the Python reader at %.1f MB/s, '
        'by key through the .idx on both; scanned (framing only) at %.1f '
        'MB/s (warm file cache)'
        % (n, 3, side, side, classes, mb, mb / write_s, mb / secs['native'],
           mb / secs['python'], mb / scan_s))
    return rec


def _record_iter(rec, spec, device_augment, **kw):
    import mxnet_tpu_torch as mt
    _, batch, image, _ = spec
    args = dict(data_shape=(3, image, image), batch_size=batch, shuffle=True,
                rand_crop=1, rand_mirror=1, mean_r=DATA_MEAN[0],
                mean_g=DATA_MEAN[1], mean_b=DATA_MEAN[2], std_r=1, std_g=1,
                std_b=1, preprocess_threads=RECORD_THREADS,
                device_augment=device_augment)
    args.update(kw)
    return mt.io.ImageRecordIter(rec, **args)


def _goodput_timeline(path):
    """(input_wait share of the wall, draw ms a step, put ms a step) from
    one fit's telemetry log."""
    recs = _jsonl(path)
    good = [r for r in recs if r['type'] == 'goodput'][-1]
    ph = [r for r in recs if r['type'] == 'timeline'][-1]['per_host'][0][
        'phases']
    return (good['buckets']['input_wait'] / good['wall_s'], ph['draw'],
            ph['put'])


def augment_vs_host(device, rec, spec):
    """(q1): one batch of the device augment (cropping on the card, and
    after the workers' host crop) against the host augment, with the
    randomness off."""
    import torch
    ctx = _ctx_of(device)
    plain = dict(shuffle=False, rand_crop=0, rand_mirror=0)
    host = _record_iter(rec, spec, 0, **plain)
    with ctx:
        want = host.next().data[0].handle.to(device)
        for hc in (0, 1):
            dev = _record_iter(rec, spec, 1, host_crop=hc, **plain)
            got = dev.next().data[0].handle
            check(got.device.type == device.type and got.dtype ==
                  torch.float32, 'the device augment gave %s %s'
                  % (got.device, got.dtype))
            rel = float(((got - want).abs() / want.abs().clamp_min(1e-30))
                        .max())
            log('  the device augment (%s) against the host augment, '
                'randomness off, one batch %s: %s, max relative error %.3e '
                '(held to %g)' % ('host crop, mirror and normalise on the '
                                  'card' if hc else 'crop, mirror and '
                                  'normalise on the card', tuple(got.shape),
                                  'bit for bit' if torch.equal(got, want)
                                  else 'NOT bit for bit', rel, AUG_RTOL))
            check(got.shape == want.shape and rel <= AUG_RTOL,
                  'the device augment disagrees with the host augment')


def _ctx_of(device):
    import mxnet_tpu_torch as mt
    return mt.gpu(device.index or 0) if device.type == 'cuda' else mt.cpu()


def record_fit(device, rec, work, spec=RESNET, n_images=RECORD_IMAGES,
               nd_figures=None):
    """Phase (q1): train_imagenet's --data-train recipe from (q0)'s file
    through ImageRecordIter and Module.fit, three ways under cuDNN's
    deterministic algorithms (the per-batch loop on the host augment, the
    window on the host augment, the window on the deferred device
    augment), each from the same masters after random.seed(RECORD_SEED):
    batch 1 of run 1 against NDArrayIter, run 3's window 1 against 4
    per-batch steps on the eager device augment, the losses finite; the
    runs' speeds and input figures printed beside (l1)/(m1)'s."""
    import contextlib
    import logging
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.module.window_pipeline import window_size
    name, batch, image, classes = spec
    on_card = device.type == 'cuda'
    ctx = _ctx_of(device)
    n_batches = n_images // batch
    W = window_size()
    t0 = time.perf_counter()
    probe = _record_iter(rec, spec, 0)
    sym = _zoo_symbol(name, classes, (batch, 3, image, image))
    mod = mt.mod.Module(sym) if on_card else mt.mod.Module(sym, context=ctx)
    mod.bind(probe.provide_data, probe.provide_label)
    mt.random.seed(0)
    mod.init_params(_xavier())
    args, aux = mod.get_params()
    masters0 = {n: a.handle.detach().clone() for n, a in args.items()}
    aux0 = {n: a.handle.detach().clone() for n, a in aux.items()}
    names = sorted(masters0)
    log('  Module(%s under SoftmaxOutput) on %s; ImageRecordIter(%s, '
        'data_shape (3, %d, %d), batch %d, shuffle, rand_crop, rand_mirror, '
        'means %s, std 1, preprocess_threads %d): %d batches an epoch; set up '
        'in %.1f s' % (name, mod._context, os.path.basename(rec), image,
                       image, batch, DATA_MEAN, RECORD_THREADS, n_batches,
                       time.perf_counter() - t0))

    def restore():
        mod.set_params({n: mt.nd.from_torch(t.clone(), ctx)
                        for n, t in masters0.items()},
                       {n: mt.nd.from_torch(t.clone(), ctx)
                        for n, t in aux0.items()})
        mod.init_optimizer(kvstore='device', optimizer='sgd',
                           optimizer_params=FIT_OPT, force_init=True)

    def one_fit(label, it, fused, capture=False, tele=False):
        """One epoch from the masters; returns what it saw."""
        restore()
        seen = {'loss': [], 'ev': [], 'wall': [], 'speed': [],
                'windows': [], 'fused': fused}
        prev = {'ce': (0.0, 0)}

        def cb(param):
            ce = param.eval_metric.get_metric(1)
            cur = (ce.sum_metric, ce.num_inst)
            if cur[1] < prev['ce'][1]:
                prev['ce'] = (0.0, 0)
            seen['loss'].append((cur[0] - prev['ce'][0]) /
                                max(cur[1] - prev['ce'][1], 1))
            prev['ce'] = cur
            if capture and param.nbatch == 0:
                b = param.locals['data_batch']
                seen['batch1'] = (b.data[0].asnumpy(), b.label[0].asnumpy())
                seen['out1'] = mod.get_outputs()[0].handle.detach().clone()
                seen['after1'] = {n: v.handle.detach().clone()
                                  for n, v in mod.get_params()[0].items()}
                seen['bytes'] = b.data[0].handle.numel() * \
                    b.data[0].handle.element_size()
            if on_card and not fused:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                seen['ev'].append(ev)
            seen['wall'].append(time.perf_counter())

        class Speeds(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if 'Speed:' in msg:
                    seen['speed'].append(
                        float(msg.split('Speed: ')[1].split()[0]))
        handler = Speeds()
        root = logging.getLogger()
        level = root.level
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        path = os.path.join(work, 'q1-%s.jsonl' % label) if tele else None
        env = {'MXTPU_FUSED_FIT': '1' if fused else '0'}
        if tele:
            env.update(MXTPU_TELEMETRY='1', MXTPU_TELEMETRY_PATH=path,
                       MXTPU_TIMELINE='1')
        timed = _timed_windows(device, seen['windows']) if fused \
            else contextlib.nullcontext()
        try:
            with _flags_set(**env):
                telemetry._reset_for_tests()
                mt.random.seed(RECORD_SEED)
                it.reset()
                _sync(device)
                t = time.perf_counter()
                with ctx, timed:
                    mod.fit(it, num_epoch=1, optimizer='sgd',
                            optimizer_params=FIT_OPT,
                            eval_metric=['acc', 'ce'], kvstore='device',
                            batch_end_callback=[cb, mt.callback.Speedometer(
                                batch, FIT_SPEEDOMETER)])
                _sync(device)
                seen['fit_s'] = time.perf_counter() - t
                if tele:
                    telemetry.write_summary(log=False)
                    telemetry.shutdown()
        finally:
            telemetry._reset_for_tests()
            root.removeHandler(handler)
            root.setLevel(level)
        if tele:
            seen['input'] = _goodput_timeline(path)
        check(('_fused_fit_cache' in mod.__dict__) == fused,
              'run %s did not take the %s loop'
              % (label, 'windowed' if fused else 'per-batch'))
        if fused:
            loop = mod.__dict__['_fused_fit_cache'][1]
            seen['loop'] = (loop.windows, loop.tail_batches)
        return seen

    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        it_host = _record_iter(rec, spec, 0)
        it_dev = _record_iter(rec, spec, 1)
        runs = {'1 per-batch, host augment':
                one_fit('per-batch', it_host, False, capture=True, tele=True),
                '2 window, host augment':
                one_fit('window', it_host, True, tele=True),
                '3 window, deferred device augment':
                one_fit('deferred', it_dev, True, tele=True)}
        # a deferred batch's bytes: the raw uint8 batch the window uploads
        check(it_dev.defer_device_aug(True), 'the device augment did not '
              'take the deferred switch')
        try:
            it_dev.reset()
            raw = it_dev.next().data[0].handle
        finally:
            it_dev.defer_device_aug(False)
        u8_bytes = raw.numel() * raw.element_size()
        f32_bytes = runs['1 per-batch, host augment']['bytes']
        for label, seen in runs.items():
            check(len(seen['loss']) == n_batches and
                  all(np.isfinite(seen['loss'])),
                  'run %s: a loss is not finite or a batch is missing: %s'
                  % (label, seen['loss']))
            if seen['fused']:
                check(seen['loop'] == (n_batches // W, n_batches % W),
                      'run %s ran %s windows and tail batches'
                      % (label, seen['loop']))
                syncs = [s_ for _, _, ss, _ in seen['windows'] for s_ in ss]
                log('  run %s: synchronising calls inside the windows (torch '
                    'sync debug mode): %s' % (label, len(syncs) if on_card
                                              else 'not measured off the '
                                              'card'))
                check(not syncs, 'run %s\'s window synchronised with the '
                      'device: %s' % (label, syncs[:3]))
            if seen['ev']:
                evs = seen['ev']
                ev_ms = statistics.median(evs[i].elapsed_time(evs[i + 1])
                                          for i in range(len(evs) - 1))
            elif seen['windows'] and seen['windows'][-1][0]:
                ev = seen['windows'][-1][0]
                ev_ms = ev[0].elapsed_time(ev[1]) / W
            else:
                ev_ms = None
            wait, draw, put = seen['input']
            log('  run %s: losses %s; %.1f images/s over the epoch (%.3f ms '
                'of host wall a batch, synchronised at the end); a batch %s '
                'by CUDA events (%s); input_wait %.1f%% of the wall '
                '(goodput); draw %s ms and put %s ms a step (timeline); '
                'bytes uploaded a batch %d (%s); Speedometer %s samples/s'
                % (label, ['%.4f' % v for v in seen['loss']],
                   n_images / seen['fit_s'], seen['fit_s'] * 1e3 / n_batches,
                   '%.3f ms' % ev_ms if ev_ms else 'not measured',
                   'the second window over its %d steps' % W
                   if seen['fused'] else
                   'median over batches 2-%d' % n_batches,
                   100 * wait, draw, put,
                   u8_bytes if label.startswith('3') else f32_bytes,
                   'uint8' if label.startswith('3') else 'f32',
                   seen['speed']))
        nd = nd_figures or {}
        pb, wn = nd.get('per_batch') or {}, nd.get('window') or {}
        log('  beside NDArrayIter over host arrays, this run: (l1) per batch '
            '%s by CUDA events, %s of host wall; (m1) a window batch %s by '
            'CUDA events, %s of host wall; f32 bytes a batch %d against the '
            'deferred augment\'s %d uint8 (%.2fx fewer)'
            % ('%.3f ms' % pb['batch_ms'] if pb.get('batch_ms')
               else 'not measured',
               '%.3f ms' % pb['wall_ms'] if pb.get('wall_ms')
               else 'not measured',
               '%.3f ms' % wn['win_ms'] if wn.get('win_ms')
               else 'not measured',
               '%.3f ms' % wn['wall_ms'] if wn.get('wall_ms')
               else 'not measured', f32_bytes, u8_bytes,
               f32_bytes / u8_bytes))

        # batch 1 of run 1 against the same decoded batch through
        # NDArrayIter from the same masters
        first = runs['1 per-batch, host augment']
        X1, y1 = first['batch1']
        restore()
        ref = {}

        def ref_cb(param):
            ref['out1'] = mod.get_outputs()[0].handle.detach().clone()
            ref['after1'] = {n: v.handle.detach().clone()
                             for n, v in mod.get_params()[0].items()}
        with _per_batch(), ctx:
            mod.fit(mt.io.NDArrayIter(X1, y1, batch_size=batch), num_epoch=1,
                    optimizer='sgd', optimizer_params=FIT_OPT,
                    eval_metric=['acc', 'ce'], kvstore='device',
                    batch_end_callback=ref_cb)
        same_out = bool(torch.equal(first['out1'], ref['out1']))
        same_par = all(torch.equal(first['after1'][n], ref['after1'][n])
                       for n in names)
        log('  run 1\'s batch 1 against the same decoded batch through '
            'NDArrayIter from the same masters: outputs %s, parameters after '
            'the update %s (held bit for bit; max abs difference %.3e)'
            % ('bit for bit' if same_out else 'NOT bit for bit',
               'bit for bit' if same_par else 'NOT bit for bit',
               float((first['out1'] - ref['out1']).abs().max())))
        check(same_out and same_par, 'run 1\'s batch 1 disagrees with '
              'NDArrayIter')

        # run 3's window 1 against 4 per-batch steps on the eager device
        # augment, from the same masters and the same random state
        restore()
        with _per_batch(), ctx:
            mt.random.seed(RECORD_SEED)
            it_dev.reset()
            mod.fit(mt.io.ResizeIter(it_dev, W), num_epoch=1,
                    optimizer='sgd', optimizer_params=FIT_OPT,
                    eval_metric=['acc', 'ce'], kvstore='device')
        win1 = runs['3 window, deferred device augment']['windows'][0][3]
        after = {n: v.handle.detach() for n, v in mod.get_params()[0].items()}
        err = rel_rms(_concat_update(names, masters0, win1),
                      _concat_update(names, masters0, after))
        same = all(torch.equal(win1[n].to(after[n].device), after[n])
                   for n in names)
        log('  run 3\'s masters after window 1 against %d per-batch steps on '
            'the eager device augment from the same masters and random '
            'state: %s (update relative RMS error %.3e; held bit for bit)'
            % (W, 'bit for bit' if same else 'NOT bit for bit', err))
        check(same, 'the deferred window disagrees with the per-batch loop '
              'on the eager device augment')
        augment_vs_host(device, rec, spec)
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    del mod


def _write_idx(path_img, path_lab, images, labels):
    """MNIST's idx files (gzipped where the name ends in .gz)."""
    import gzip
    for path, head, body in (
            (path_img, struct.pack('>IIII', 2051, len(images), 28, 28),
             images.astype(np.uint8).tobytes()),
            (path_lab, struct.pack('>II', 2049, len(labels)),
             labels.astype(np.uint8).tobytes())):
        opener = gzip.open if path.endswith('.gz') else open
        with opener(path, 'wb') as f:
            f.write(head + body)


def mnist_paths(device, work, n=MNIST_IMAGES):
    """Phase (q2): MNISTIter over idx files written from synthetic_mnist
    into an MLP through Module.fit (its accuracy above MNIST_ACC), and
    gluon.data.vision.MNIST through transform_first and the DataLoader into
    a Gluon MLP with split_and_load, autograd.record(), the loss and
    Trainer (its loss falling)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon, nd
    ctx = _ctx_of(device)
    images, labels = mt.io.synthetic_mnist(n, seed=0)
    pixels = (images * 255).astype(np.uint8)
    img_path = os.path.join(work, 'train-images-idx3-ubyte')
    lab_path = os.path.join(work, 'train-labels-idx1-ubyte')
    _write_idx(img_path, lab_path, pixels, labels)
    it = mt.io.MNISTIter(image=img_path, label=lab_path,
                         batch_size=MNIST_BATCH, flat=True)
    data = mt.sym.Variable('data')
    net = mt.sym.Activation(mt.sym.FullyConnected(data, num_hidden=128,
                                                  name='fc1'),
                            act_type='relu')
    net = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(net, num_hidden=10,
                                                     name='fc2'),
                               name='softmax')
    mod = mt.mod.Module(net, context=ctx)
    t0 = time.perf_counter()
    mt.random.seed(0)
    mod.fit(it, num_epoch=1, optimizer='sgd',
            optimizer_params={'learning_rate': 0.1}, eval_metric='acc',
            initializer=_xavier(), kvstore='device')
    fit_s = time.perf_counter() - t0
    acc = dict(mod.score(it, 'acc'))['accuracy']
    log('  MNISTIter over idx files of %d synthetic images (batch %d, flat) '
        '-> MLP 784-128-10 through Module.fit, one epoch in %.2f s: accuracy '
        '%.4f after it (chance 0.1; held above %g)'
        % (n, MNIST_BATCH, fit_s, acc, MNIST_ACC))
    check(acc > MNIST_ACC, 'the MNIST fit did not learn')

    root = os.path.join(work, 'mnist')
    os.makedirs(root, exist_ok=True)
    _write_idx(os.path.join(root, 'train-images-idx3-ubyte.gz'),
               os.path.join(root, 'train-labels-idx1-ubyte.gz'), pixels,
               labels)
    dataset = gluon.data.vision.MNIST(root=root).transform_first(
        lambda x: x.astype('float32') / 255)
    loader = gluon.data.DataLoader(dataset, batch_size=GLUON_MNIST_BATCH,
                                   shuffle=True)
    with mt.name.NameManager():
        mlp = gluon.nn.Sequential()
        with mlp.name_scope():
            mlp.add(gluon.nn.Dense(128, activation='relu'))
            mlp.add(gluon.nn.Dense(10))
    mlp.initialize(mt.init.Xavier(), ctx=ctx)
    trainer = gluon.Trainer(mlp.collect_params(), 'sgd',
                            {'learning_rate': 0.1})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    t0 = time.perf_counter()
    for xb, yb in loader:
        check(xb.context == mt.cpu() and yb.context == mt.cpu(),
              'the DataLoader gave a batch off the host')
        x = gluon.utils.split_and_load(xb, [ctx])[0]
        y = gluon.utils.split_and_load(yb, [ctx])[0]
        with autograd.record():
            loss = loss_fn(mlp(x), y)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.mean().asscalar()))
    loop_s = time.perf_counter() - t0
    head, tail = np.mean(losses[:5]), np.mean(losses[-5:])
    log('  gluon.data.vision.MNIST(root) -> transform_first -> '
        'DataLoader(batch %d, shuffle) -> split_and_load -> Gluon MLP on %s: '
        '%d batches in %.2f s, loss %.4f over the first 5, %.4f over the last '
        '5 (held falling)' % (GLUON_MNIST_BATCH, x.context, len(losses),
                              loop_s, head, tail))
    check(all(np.isfinite(losses)) and tail < head,
          'the Gluon MNIST loop\'s loss did not fall')


def data_head(device, cfg, batches=DATA_HEAD_BATCHES):
    """Phase (q3): (l2)'s head inputs through ArrayDataset, the DataLoader
    and split_and_load into nd.LayerNorm (K4) -> nd.FullyConnected -> Cast
    f32 -> nd.softmax_cross_entropy (K3) under autograd.record(), backward
    and gluon.Trainer(sgd).step over its Parameters: the launches (3 and 3,
    K5 and K6 0) and each batch's loss against the plain versions on the
    parameters it ran with. Returns {wrapper: launches}."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    ctx = _ctx_of(device)
    N, D, V = MAX_BATCH * cfg.seq_len, cfg.d_model, cfg.vocab
    rng = np.random.RandomState(22)
    X = rng.standard_normal((batches * N, D)).astype(np.float32)
    y = rng.randint(0, V, batches * N).astype(np.int32)
    loader = gluon.data.DataLoader(gluon.data.ArrayDataset(X, y),
                                   batch_size=N)
    params = gluon.ParameterDict('head_')
    gamma = params.get('gamma', shape=(D,), init=mt.init.One())
    beta = params.get('beta', shape=(D,), init=mt.init.Zero())
    weight = params.get('weight', shape=(V, D))
    mt.random.seed(0)
    params.initialize(_xavier(), ctx=ctx)
    trainer = gluon.Trainer(params, 'sgd', dict(FIT_OPT))
    counters = (ck.layernorm_fwd, ck.rmsnorm_fwd, ck.softmax_fwd,
                ck.softmax_xent_fwd)
    errs, losses = [], []
    # the main path: counts are zeroed just before and read just after
    for fwd in counters:
        fwd.launches = 0
    for xb, yb in loader:
        x = gluon.utils.split_and_load(xb, [ctx])[0]
        lab = gluon.utils.split_and_load(yb, [ctx])[0]
        before = [p.data(ctx).handle.detach().clone()
                  for p in (gamma, beta, weight)]
        with autograd.record():
            h = nd.LayerNorm(x, gamma.data(ctx), beta.data(ctx))
            logits = nd.Cast(nd.FullyConnected(h, weight.data(ctx),
                                               num_hidden=V, no_bias=True),
                             dtype='float32')
            loss = nd.softmax_cross_entropy(logits, lab)
        loss.backward()
        trainer.step(N)
        got = float(loss.asnumpy().sum())
        with torch.no_grad():
            hr = ck.layernorm_ref(x.handle, before[0], before[1])
            want = float(ck.softmax_xent_ref((hr @ before[2].t()).float(),
                                             lab.handle).sum())
        losses.append(got)
        errs.append(abs(got - want) / abs(want))
    launches = {fwd.__name__: fwd.launches for fwd in counters}
    want = {'layernorm_fwd': batches, 'rmsnorm_fwd': 0, 'softmax_fwd': 0,
            'softmax_xent_fwd': batches}
    if device.type != 'cuda':
        want = dict.fromkeys(want, 0)
    log('  ArrayDataset(x [%d, %d] f32, labels) -> DataLoader(batch %d) -> '
        'split_and_load -> LayerNorm -> FullyConnected to %d -> f32 -> '
        'softmax_cross_entropy under autograd.record(), backward, '
        'Trainer(sgd).step: %d batches, launches %s; losses %s, relative '
        'errors against the plain versions %s (held to %g)'
        % (batches * N, D, N, V, len(losses), launches,
           ['%.2f' % v for v in losses], ['%.3e' % e for e in errs],
           DATA_HEAD_RTOL))
    check(launches == want, 'the data path\'s launches %s != %s'
          % (launches, want))
    check(len(errs) == batches and max(errs) <= DATA_HEAD_RTOL,
          'a batch\'s loss through the DataLoader disagrees with the plain '
          'versions')
    return launches


def phase_q(device, cfg, work, spec=RESNET, n_images=RECORD_IMAGES,
            side=RECORD_SIDE, nd_figures=None):
    """Phase (q): (q0) the record file on the native writer and both
    readers, (q1) train_imagenet's --data-train recipe from it, (q2) the
    MNIST paths, (q3) K3 and K4 fed by the Gluon data path. Returns (q3)'s
    launches."""
    t0 = time.perf_counter()
    log('  (q0) the record file')
    rec = records(work, n_images, side, spec[3])
    log('  (q1) train_imagenet\'s --data-train recipe through ImageRecordIter '
        'and Module.fit: %s, batch %d' % (spec[0], spec[1]))
    record_fit(device, rec, work, spec, n_images, nd_figures)
    log('  (q2) the MNIST paths')
    mnist_paths(device, work)
    log('  (q3) K3 and K4 fed by the Gluon data path')
    launches = data_head(device, cfg)
    log('  phase (q) took %.1f s' % (time.perf_counter() - t0))
    return launches


# ---------------------------------------------------------------------------
# (r) the RNN stack on the card
# ---------------------------------------------------------------------------

# lstm_bucketing at MXNet's own example widths (example/rnn/
# lstm_bucketing.py: num_embed 200, num_hidden 200, two layers, batch 32,
# buckets 10-60, sgd lr 0.01, wd 1e-5, Xavier(in, 2.34)) at Penn Treebank's
# vocabulary of 10,000 words, on sentences from a seeded stream (the PTB
# files are not in the repository): lengths 5-60, tokens Zipf-distributed
# over the vocabulary (p ~ 1/rank), LM_BATCHES batches a bucket, two passes.
LM_VOCAB, LM_EMBED, LM_HIDDEN, LM_LAYERS = 10000, 200, 200, 2
LM_BATCH = 32
LM_BUCKETS = [10, 20, 30, 40, 50, 60]
LM_BATCHES = 2
LM_OPT = {'learning_rate': 0.01, 'momentum': 0.0, 'wd': 1e-5}
# Tolerances on the card (chip_smoke turns TF32 off for cuBLAS and cuDNN,
# torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 =
# False, so every f32 matmul and cuDNN's LSTM run in full f32), each a
# relative RMS error:
# - (r1) the first batch on the card against the same module on the CPU:
#   softmax outputs 1e-5, gradients 1e-4 (the same f32 graph, the matmuls
#   summed in another order by cuBLAS and the CPU's BLAS; the gradients
#   through up to 60 steps of two LSTM layers);
# - (r2) the fused LSTM (cuDNN) against its unfuse() cells on the same
#   weights on the card: outputs 1e-5; the RNN op's fused body against
#   _rnn_plain at the model's shape: outputs and final states 1e-5,
#   gradients 1e-4 (cuDNN sums its gates in another order);
# - (r3) the held-out loss through nd.softmax_cross_entropy (K3) against
#   the sum of gluon's SoftmaxCrossEntropyLoss: 1e-4 relative (per-row
#   losses of ~9 summed over 1,120 rows in another order); K3's per-row
#   losses at that [1120, 10000] against the plain -log_softmax pick, row
#   by row: |got - want| <= 1e-5 + 1e-5 |want| (ROW_TOL's f32 pair);
# - (r4) each decoded token's probabilities against the per-step reference
#   (the same step at batch 1, on the CPU, so that K5 is on one side only):
#   |got - want| <= 1e-8 + 1e-4 |want| (cuBLAS and the CPU's BLAS sum in
#   another order: the logits move by a few f32 ulps, the probabilities by
#   as many parts in 1e5); K5 alone at [16, 10000] f32 (unit normal rows,
#   probabilities of about 1e-4) against its plain version:
#   |got - want| <= 1e-7 + 1e-5 |want|;
# - (r5) the CTC loss and its gradient on the card against the CPU: 1e-5
#   relative, the gradient's excess over 1e-5 |cpu| at most 1e-6 (the same
#   f32 recursion, log-sum-exps in another order).
LM_OUT_RTOL = 1e-5
LM_GRAD_RTOL = 1e-4
LM_XENT_RTOL = 1e-4
DECODE_RTOL, DECODE_ATOL = 1e-4, 1e-8
# K5 alone at the decode's rows: a probability here is about 1e-4, so the
# absolute slack is kept far below it
K5_RTOL, K5_ATOL = 1e-5, 1e-7
CTC_RTOL = 1e-5
# (r3) Gluon's word language model (examples/gluon/word_language_model.py's
# loop: the mean loss of a window, its gradient clipped to a global norm,
# Trainer.step(1); with its tied weights, at bptt 35 and batch 32, on sgd at
# lr 20 and a clip of 0.25, the settings of the reference's word LM)
WLM_BPTT, WLM_STEPS, WLM_LR, WLM_CLIP = 35, 8, 20.0, 0.25
# (r4) 20 sessions over 16 slots, 16 tokens each
DECODE_SESSIONS, DECODE_CAPACITY, DECODE_TOKENS = 20, 16, 16
# (r5) examples/ctc/lstm_ocr.py's recipe
OCR_BATCH, OCR_BATCHES = 64, 8


def lm_sentences(seed=0, buckets=LM_BUCKETS, per_bucket=LM_BATCHES * LM_BATCH,
                 vocab=LM_VOCAB):
    """LM_BATCHES batches a bucket of sentences whose lengths fill the
    bucket's range (the first from 5), tokens 1..V-1 by Zipf's law (0 is
    the padding label)."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab)
    p /= p.sum()
    out, lo = [], 5
    for b in buckets:
        for n in rng.randint(lo, b + 1, per_bucket):
            out.append(list(rng.choice(vocab - 1, n, p=p) + 1))
        lo = b + 1
    return out


def lm_sym_gen(fused=False, vocab=LM_VOCAB):
    """lstm_bucketing's sym_gen: Embedding -> two LSTM layers (LSTMCells in
    a SequentialRNNCell, or one FusedRNNCell) -> FullyConnected to the
    vocabulary -> SoftmaxOutput."""
    import mxnet_tpu_torch as mt
    if fused:
        stack = mt.rnn.FusedRNNCell(LM_HIDDEN, num_layers=LM_LAYERS,
                                    mode='lstm', prefix='lstm_')
    else:
        stack = mt.rnn.SequentialRNNCell()
        for i in range(LM_LAYERS):
            stack.add(mt.rnn.LSTMCell(num_hidden=LM_HIDDEN,
                                      prefix='lstm_l%d_' % i))

    def sym_gen(seq_len):
        data = mt.sym.Variable('data')
        label = mt.sym.Variable('softmax_label')
        embed = mt.sym.Embedding(data=data, input_dim=vocab,
                                 output_dim=LM_EMBED, name='embed')
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mt.sym.Reshape(outputs, shape=(-1, LM_HIDDEN))
        pred = mt.sym.FullyConnected(data=pred, num_hidden=vocab, name='pred')
        label = mt.sym.Reshape(label, shape=(-1,))
        pred = mt.sym.SoftmaxOutput(data=pred, label=label, name='softmax')
        return pred, ('data',), ('softmax_label',)
    return sym_gen, stack


def _lm_iter(sentences):
    import mxnet_tpu_torch as mt
    mt.random.seed(3)
    return mt.rnn.BucketSentenceIter(sentences, LM_BATCH, buckets=LM_BUCKETS,
                                     invalid_label=0)


def _bucketing(device, fused=False, vocab=LM_VOCAB):
    import mxnet_tpu_torch as mt
    gen, stack = lm_sym_gen(fused, vocab)
    return mt.mod.BucketingModule(gen, default_bucket_key=max(LM_BUCKETS),
                                  context=_ctx_of(device)), stack


def _params_np(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _set_params(mod, weights):
    """A bound, initialised Module's or BucketingModule's parameters from a
    dict of numpy arrays by name (every bucket's, through set_params)."""
    import mxnet_tpu_torch as mt
    mod.set_params({k: mt.nd.array(v, ctx=mt.cpu())
                    for k, v in weights.items()}, {})


def _fwd_bwd(mod, batch):
    """The first batch's softmax outputs and every parameter's gradient."""
    mod.forward(batch, is_train=True)
    mod.backward()
    cur = mod._curr_module._exec_group
    grads = {n: g[0].handle.detach().clone()
             for n, g in zip(cur.param_names, cur.grad_arrays)}
    return mod.get_outputs()[0].handle.detach().clone(), grads


def _timed_fit(mod, it, epochs, opt, device, metric):
    """fit with a batch_end_callback that syncs the card and records (epoch,
    bucket, host wall ms since the last batch, the metric's value)."""
    rows = []
    state = {'t': None}

    def on_batch(param):
        _sync(device)
        now = time.perf_counter()
        if state['t'] is not None and param.nbatch > 0:
            rows.append((param.epoch, mod._curr_bucket_key,
                         (now - state['t']) * 1e3,
                         param.eval_metric.get()[1]))
        state['t'] = now

    def on_epoch(*args):
        state['t'] = None
    mod.fit(it, num_epoch=epochs, eval_metric=metric, optimizer='sgd',
            optimizer_params=opt, batch_end_callback=on_batch,
            epoch_end_callback=on_epoch)
    return rows


def _per_bucket(rows, epoch):
    out = {}
    for e, key, ms, _ in rows:
        if e == epoch:
            out.setdefault(key, []).append(ms)
    return {k: statistics.median(v) for k, v in sorted(out.items())}


def lm_bucketing(device, sentences=None, vocab=LM_VOCAB):
    """Phase (r1): lstm_bucketing through BucketingModule.fit. Returns
    (the initial weights, {bucket: ms a batch} of the second pass)."""
    import torch
    import mxnet_tpu_torch as mt
    sentences = sentences if sentences is not None else lm_sentences()
    it = _lm_iter(sentences)
    first = next(iter(it))
    it.reset()
    mod, _ = _bucketing(device, vocab=vocab)
    mod.bind(it.provide_data, it.provide_label)
    mt.random.seed(0)
    mod.init_params(mt.init.Xavier(factor_type='in', magnitude=2.34))
    init = _params_np(mod)
    out, grads = _fwd_bwd(mod, first)
    cpu, _ = _bucketing(torch.device('cpu'), vocab=vocab)
    cpu.bind(it.provide_data, it.provide_label)
    cpu.init_params()
    _set_params(cpu, init)
    c_out, c_grads = _fwd_bwd(cpu, first)
    out_err = rel_rms(out.cpu(), c_out)
    grad_err = max(rel_rms(grads[n].cpu(), c_grads[n]) for n in c_grads)
    log('  (r1) first batch (bucket %d) on %s against the CPU: softmax '
        'outputs relative RMS %.3e (held to %g), the worst of %d gradients '
        '%.3e (held to %g)' % (first.bucket_key, device, out_err,
                               LM_OUT_RTOL, len(c_grads), grad_err,
                               LM_GRAD_RTOL))
    check(out_err <= LM_OUT_RTOL, '(r1) outputs disagree with the CPU')
    check(grad_err <= LM_GRAD_RTOL, '(r1) gradients disagree with the CPU')
    rows = _timed_fit(mod, it, 2, LM_OPT, device,
                      mt.metric.Perplexity(ignore_label=None))
    final = _params_np(mod)
    ppl = [[r[3] for r in rows if r[0] == e][-1] for e in (0, 1)]
    finite = all(np.isfinite(v).all() for v in final.values()) \
        and all(np.isfinite(r[3]) for r in rows)
    times = _per_bucket(rows, 1)
    log('  (r1) BucketingModule.fit: vocabulary %d, embed %d, 2 x LSTMCell '
        '%d, batch %d, buckets %s, %d batches a pass, 2 passes: perplexity '
        '%.1f after pass 1, %.1f after pass 2 (held falling); host wall ms '
        'a batch (synced) in pass 2 by bucket: %s'
        % (vocab, LM_EMBED, LM_HIDDEN, LM_BATCH, LM_BUCKETS,
           len(rows) // 2 + 1, ppl[0], ppl[1],
           ', '.join('%d: %.2f' % kv for kv in times.items())))
    check(finite, '(r1) a parameter or the perplexity is not finite')
    check(ppl[1] < ppl[0], '(r1) the perplexity did not fall')
    check(all('_fused_fit_cache' not in m.__dict__
              for m in mod._buckets.values()),
          '(r1) BucketingModule.fit built a fused window')
    return init, final, times


def fused_lm(device, init, unrolled_ms, sentences=None, vocab=LM_VOCAB):
    """Phase (r2): the same model on mx.rnn.FusedRNNCell (the RNN op on
    cuDNN): its outputs against unfuse()'s cells on the same weights, the
    op's fused body against _rnn_plain at the model's shape, and a timed
    fit beside (r1)'s."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import registry as reg
    from mxnet_tpu_torch.ops import rnn_ops
    sentences = sentences if sentences is not None else lm_sentences()
    it = _lm_iter(sentences)
    first = next(iter(it))
    it.reset()
    mod, cell = _bucketing(device, fused=True, vocab=vocab)
    mod.bind(it.provide_data, it.provide_label)
    # the embedding and the head as (r1)'s; the LSTM weights as (r1)'s,
    # packed into the fused vector
    weights = {k: v for k, v in init.items() if not k.startswith('lstm_')}
    lstm = {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in init.items()
            if k.startswith('lstm_')}
    weights.update({k: v.asnumpy() for k, v in cell.pack_weights(
        cell.unfuse().unpack_weights(lstm)).items()})
    mod.init_params()
    _set_params(mod, weights)
    unfused, _ = _bucketing(device, vocab=vocab)
    unfused.bind(it.provide_data, it.provide_label)
    unfused.init_params()
    _set_params(unfused, init)
    outs = []
    for m in (mod, unfused):
        m.forward(first, is_train=False)
        outs.append(m.get_outputs()[0].handle.detach().clone())
    err = rel_rms(outs[0], outs[1])
    log('  (r2) FusedRNNCell(%d, num_layers=%d, mode=lstm) on cuDNN against '
        'its unfuse() cells on the same weights, bucket %d: relative RMS '
        '%.3e (held to %g)' % (LM_HIDDEN, LM_LAYERS, first.bucket_key, err,
                               LM_OUT_RTOL))
    check(err <= LM_OUT_RTOL, '(r2) the fused LSTM disagrees with unfuse()')
    # the op's fused body against its plain version at the model's shape
    T, N = max(LM_BUCKETS), LM_BATCH
    size = rnn_ops.rnn_param_size(LM_LAYERS, LM_HIDDEN, LM_EMBED, False,
                                  'lstm')
    gen = torch.Generator(device=device).manual_seed(8)
    xs = [torch.randn(T, N, LM_EMBED, generator=gen, device=device),
          torch.rand(size, generator=gen, device=device) * 0.14 - 0.07,
          torch.randn(LM_LAYERS, N, LM_HIDDEN, generator=gen, device=device),
          torch.randn(LM_LAYERS, N, LM_HIDDEN, generator=gen, device=device)]
    attrs = {'state_size': LM_HIDDEN, 'num_layers': LM_LAYERS, 'mode': 'lstm',
             'state_outputs': True, '__is_train__': False}
    res = []
    for fn in (reg.get('RNN').fn, rnn_ops._rnn_plain):
        ins = [x.clone().requires_grad_() for x in xs]
        o = fn(attrs, *ins, None)
        cot = torch.Generator(device=device).manual_seed(9)
        torch.autograd.backward(o, [torch.randn(t.shape, generator=cot,
                                                device=device) for t in o])
        res.append(([t.detach() for t in o], [x.grad for x in ins]))
    o_err = max(rel_rms(a, b) for a, b in zip(res[0][0], res[1][0]))
    g_err = max(rel_rms(a, b) for a, b in zip(res[0][1], res[1][1]))
    log('  (r2) the RNN op\'s fused body (torch.lstm on cuDNN) against '
        '_rnn_plain at T %d, N %d, 2 x %d: outputs and final states %.3e '
        '(held to %g), gradients %.3e (held to %g)'
        % (T, N, LM_HIDDEN, o_err, LM_OUT_RTOL, g_err, LM_GRAD_RTOL))
    check(o_err <= LM_OUT_RTOL, '(r2) the fused body disagrees with '
          '_rnn_plain')
    check(g_err <= LM_GRAD_RTOL, '(r2) the fused body\'s gradients disagree '
          'with _rnn_plain')
    rows = _timed_fit(mod, it, 2, LM_OPT, device,
                      mt.metric.Perplexity(ignore_label=None))
    times = _per_bucket(rows, 1)
    check(all(np.isfinite(r[3]) for r in rows), '(r2) perplexity not finite')
    log('  (r2) host wall ms a batch (synced) in pass 2 by bucket, fused '
        'against (r1)\'s unrolled cells: %s'
        % ', '.join('%d: %.2f / %.2f' % (k, v, unrolled_ms.get(k, float('nan')))
                    for k, v in times.items()))
    return times


def word_lm(device, vocab=LM_VOCAB, steps=WLM_STEPS):
    """Phase (r3): Gluon's word language model, Embedding -> gluon.rnn.LSTM
    (two layers, dropout 0.2) -> a Dense tied to the embedding, trained
    with truncated BPTT (the hidden state carried and detached),
    clip_global_norm and Trainer('sgd'); the held-out loss through
    nd.softmax_cross_entropy (K3) against SoftmaxCrossEntropyLoss. Returns
    {wrapper: launches}."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.gluon import nn, rnn
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    ctx = _ctx_of(device)
    rng = np.random.RandomState(4)
    p = 1.0 / np.arange(1, vocab + 1)
    tokens = rng.choice(vocab, (steps + 1) * WLM_BPTT * LM_BATCH + LM_BATCH,
                        p=p / p.sum())
    data = tokens[:len(tokens) // LM_BATCH * LM_BATCH].reshape(
        LM_BATCH, -1).T.astype(np.float32)             # (T, batch)

    class Model(gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.embedding = nn.Embedding(vocab, LM_EMBED)
                self.lstm = rnn.LSTM(LM_HIDDEN, num_layers=LM_LAYERS,
                                     dropout=0.2, input_size=LM_EMBED)
                self.decoder = nn.Dense(vocab, flatten=False,
                                        in_units=LM_HIDDEN,
                                        params=self.embedding.params)

        def forward(self, x, state):
            out, state = self.lstm(self.embedding(x), state)
            return self.decoder(out), state
    mt.random.seed(1)
    with mt.name.NameManager(), ctx:
        model = Model()
        model.initialize(mt.init.Xavier(), ctx=ctx)
        params = model.collect_params()
        trainer = gluon.Trainer(params, 'sgd', {'learning_rate': WLM_LR})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        counters = (ck.layernorm_fwd, ck.rmsnorm_fwd, ck.softmax_fwd,
                    ck.softmax_xent_fwd)
        # the main path: counts are zeroed just before and read just after
        for fwd in counters:
            fwd.launches = 0
        hidden = model.lstm.begin_state(batch_size=LM_BATCH, ctx=ctx)
        losses = []
        t0 = time.perf_counter()
        for i in range(steps):
            x = nd.array(data[i * WLM_BPTT:(i + 1) * WLM_BPTT], ctx=ctx)
            y = nd.array(data[i * WLM_BPTT + 1:(i + 1) * WLM_BPTT + 1],
                         ctx=ctx)
            hidden = [h.detach() for h in hidden]
            with autograd.record():
                out, hidden = model(x, hidden)
                loss = loss_fn(out.reshape((-1, vocab)),
                               y.reshape((-1,))).mean()
            loss.backward()
            gluon.utils.clip_global_norm(
                [q.grad(ctx) for q in params.values()], WLM_CLIP)
            trainer.step(1)
            losses.append(float(loss.asscalar()))
        _sync(device)
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        # the held-out chunk, after the training tokens
        x = nd.array(data[steps * WLM_BPTT:(steps + 1) * WLM_BPTT], ctx=ctx)
        y = nd.array(data[steps * WLM_BPTT + 1:(steps + 1) * WLM_BPTT + 1],
                     ctx=ctx)
        out, _ = model(x, hidden)
        logits = out.reshape((-1, vocab))
        total = float(nd.softmax_cross_entropy(logits, y.reshape((-1,)))
                      .asscalar())
        launches = {fwd.__name__: fwd.launches for fwd in counters}
        want = float(loss_fn(logits, y.reshape((-1,))).sum().asscalar())
    # K3 row by row at this shape: the kernel's per-row losses against the
    # plain -log_softmax pick on the same logits and labels
    z = logits.handle.detach()
    lab = y.reshape((-1,)).handle.long()
    k_rows = ck.softmax_xent_fwd(z, lab)
    p_rows = -torch.log_softmax(z.float(), -1).gather(1, lab[:, None])[:, 0]
    atol, rtol = ROW_TOL['float32']
    row_err = float((k_rows - p_rows).abs().max())
    row_excess = excess(k_rows, p_rows, atol, rtol)
    n = logits.shape[0]
    err = abs(total - want) / abs(want)
    head, tail = np.mean(losses[:2]), np.mean(losses[-2:])
    log('  (r3) gluon word LM: Embedding(%d, %d) -> gluon.rnn.LSTM(%d, %d '
        'layers, dropout 0.2) -> tied Dense, bptt %d, batch %d, sgd lr %g, '
        'clip %g: %d steps, %.1f ms a step, loss %s (held falling); '
        'held-out perplexity %.1f over %d tokens through '
        'nd.softmax_cross_entropy, relative error against '
        'SoftmaxCrossEntropyLoss %.3e (held to %g); launches %s; K3 row by '
        'row at [%d, %d] f32 against the plain -log_softmax pick: max|err| '
        '%.3e, excess %.3e over rtol %g (held to atol %g)'
        % (vocab, LM_EMBED, LM_HIDDEN, LM_LAYERS, WLM_BPTT, LM_BATCH, WLM_LR,
           WLM_CLIP, steps, step_ms, ['%.3f' % v for v in losses],
           math.exp(total / n), n, err, LM_XENT_RTOL, launches, n, vocab,
           row_err, row_excess, rtol, atol))
    check(all(np.isfinite(losses)) and tail < head,
          '(r3) the word LM\'s loss did not fall')
    check(err <= LM_XENT_RTOL, '(r3) the held-out loss disagrees with '
          'SoftmaxCrossEntropyLoss')
    check(row_excess <= atol and tuple(k_rows.shape) == (n,),
          '(r3) K3\'s per-row losses disagree with the plain pick')
    want_l = {'layernorm_fwd': 0, 'rmsnorm_fwd': 0, 'softmax_fwd': 0,
              'softmax_xent_fwd': 1}
    if device.type != 'cuda':
        want_l = dict.fromkeys(want_l, 0)
    check(launches == want_l, '(r3) launches %s != %s' % (launches, want_l))
    return launches


def _decode_module(device, batch, vocab=LM_VOCAB):
    """The language model's step: Embedding -> two LSTMCell steps (their
    four states as data inputs) -> FullyConnected -> softmax (K5), the new
    states as the graph's last outputs (docs/serving.md)."""
    import mxnet_tpu_torch as mt
    x = mt.sym.Variable('data')
    h = mt.sym.Embedding(data=x, input_dim=vocab, output_dim=LM_EMBED,
                         name='embed')
    names, new = ['data'], []
    for i in range(LM_LAYERS):
        s = [mt.sym.Variable('l%d_h' % i), mt.sym.Variable('l%d_c' % i)]
        names += ['l%d_h' % i, 'l%d_c' % i]
        h, st = mt.rnn.LSTMCell(LM_HIDDEN, prefix='lstm_l%d_' % i)(h, s)
        new += st
    fc = mt.sym.FullyConnected(h, num_hidden=vocab, name='pred')
    step = mt.sym.Group([mt.sym.softmax(fc, name='prob')] + new)
    mod = mt.mod.Module(step, data_names=names, label_names=[],
                        context=_ctx_of(device))
    mod.bind(data_shapes=[('data', (batch,))]
             + [(n, (batch, LM_HIDDEN)) for n in names[1:]],
             for_training=False)
    return mod, names[1:]


def decode_lm(device, weights, vocab=LM_VOCAB):
    """Phase (r4): DecodeEngine serving (r1)'s trained model one token at a
    time: 20 sessions over 16 slots, 16 tokens each (12 sessions every
    round, 8 in two alternating groups of 4 that LRU evicts and re-admits
    while the 12 run, then run on alone), every token's probabilities
    against a per-step reference (a batch-1 Module on the CPU fed its
    states); K5 at [16, 10000] f32 against its plain version. Returns
    ({wrapper: launches}, {bucket: ms a token})."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    mod, state_names = _decode_module(device, DECODE_CAPACITY, vocab)
    mod.init_params()
    _set_params(mod, weights)
    eng = mt.serving.DecodeEngine(mod, state_names=state_names,
                                  capacity=DECODE_CAPACITY,
                                  max_batch=DECODE_CAPACITY)
    eng.warmup()
    hot = ['s%d' % i for i in range(12)]
    cold = [['s%d' % i for i in range(12, 16)],
            ['s%d' % i for i in range(16, 20)]]
    rounds = []
    for t in range(2 * DECODE_TOKENS):
        if t < DECODE_TOKENS:
            rounds.append(hot)
        rounds.append(cold[t % 2])
    rng = np.random.RandomState(6)
    counters = (ck.layernorm_fwd, ck.rmsnorm_fwd, ck.softmax_fwd,
                ck.softmax_xent_fwd)
    table = mt.serving.StepCache(DECODE_CAPACITY)
    served, ms = [], {}
    # the main path: counts are zeroed just before and read just after
    for fwd in counters:
        fwd.launches = 0
    before = ck.softmax_fwd.launches_by_body.copy()
    for sids in rounds:
        tok = rng.randint(1, vocab, len(sids)).astype(np.float32)
        _, fresh = table.lookup(sids)
        t0 = time.perf_counter()
        probs = eng.decode(sids, [tok])[0]
        b = next(k for k in eng.buckets if k >= len(sids))
        ms.setdefault(b, []).append((time.perf_counter() - t0) * 1e3
                                    / len(sids))
        served.append((sids, tok, fresh, probs))
    launches = {fwd.__name__: fwd.launches for fwd in counters}
    bodies = {k: v - before.get(k, 0)
              for k, v in ck.softmax_fwd.launches_by_body.items()}
    evictions = eng.cache.evictions
    # the per-step reference: a batch-1 module on the CPU (so no K5 launch
    # is on both sides) fed each session's states
    ref, _ = _decode_module(torch.device('cpu'), 1, vocab)
    ref.init_params()
    _set_params(ref, weights)
    states, worst, max_err, n_tok, n_fresh = {}, -math.inf, 0.0, 0, 0
    for sids, tok, fresh, probs in served:
        for i, s in enumerate(sids):
            if fresh[i]:
                n_fresh += 1
                states[s] = [np.zeros((1, LM_HIDDEN), np.float32)
                             for _ in state_names]
            ref.forward(mt.io.DataBatch(data=[
                mt.nd.array(tok[i:i + 1], ctx=mt.cpu())]
                + [mt.nd.array(v, ctx=mt.cpu()) for v in states[s]]),
                is_train=False)
            o = [a.asnumpy() for a in ref.get_outputs()]
            states[s] = o[1:]
            want = o[0][0]
            diff = np.abs(probs[i] - want)
            max_err = max(max_err, float(diff.max()))
            worst = max(worst, float((diff - DECODE_RTOL * np.abs(want)).max()))
            n_tok += 1
    log('  (r4) DecodeEngine over (r1)\'s trained LM (Embedding -> 2 LSTMCell '
        'steps -> FullyConnected(%d) -> softmax): %d sessions over %d '
        'slots, %d tokens in %d dispatches, %d evictions, %d rows from zero '
        'state; probabilities against the per-step reference on the CPU: '
        'max|err| %.3e, worst excess %.3e over rtol %g (held to %g); '
        'softmax launches %s (bodies %s); ms a token by bucket: %s'
        % (vocab, DECODE_SESSIONS, DECODE_CAPACITY, n_tok, len(served),
           evictions, n_fresh, max_err, worst, DECODE_RTOL, DECODE_ATOL,
           launches,
           bodies, ', '.join('%d: %.3f' % (k, statistics.median(v))
                             for k, v in sorted(ms.items()))))
    check(n_tok == DECODE_SESSIONS * DECODE_TOKENS, '(r4) token count')
    check(evictions > 0 and n_fresh > DECODE_SESSIONS,
          '(r4) no eviction and re-admission happened')
    check(worst <= DECODE_ATOL, '(r4) decoded probabilities disagree with '
          'the per-step reference')
    want_l = {'layernorm_fwd': 0, 'rmsnorm_fwd': 0,
              'softmax_fwd': len(served), 'softmax_xent_fwd': 0}
    if device.type != 'cuda':
        want_l = dict.fromkeys(want_l, 0)
    check(launches == want_l, '(r4) launches %s != %s' % (launches, want_l))
    if device.type == 'cuda':
        check(bodies.get('block', 0) == len(served),
              '(r4) the 40 KB rows did not take the block body: %s' % bodies)
        # K5 at the decode's widest bucket: the kernel held against its
        # plain version, then kernel, plain and torch.softmax timed
        gen = torch.Generator(device=device).manual_seed(7)
        x = torch.randn(DECODE_CAPACITY, vocab, device=device, generator=gen)
        got, plain = ck.softmax_fwd(x), ck.softmax_ref(x)
        k5_err = float((got - plain).abs().max())
        k5_excess = excess(got, plain, K5_ATOL, K5_RTOL)
        log('  (r4) K5 at [%d, %d] f32 against its plain version: max|err| '
            '%.3e, excess %.3e over rtol %g (held to atol %g); the largest '
            'probability %.3e, the median %.3e'
            % (DECODE_CAPACITY, vocab, k5_err, k5_excess, K5_RTOL, K5_ATOL,
               float(plain.max()), float(plain.median())))
        check(got.shape == plain.shape and bool(torch.isfinite(got).all())
              and k5_excess <= K5_ATOL,
              '(r4) K5 disagrees with its plain version at the decode shape')
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
        k_ms = device_ms(lambda: ck.softmax_fwd(x), flush=flush)
        p_ms = device_ms(lambda: ck.softmax_ref(x), flush=flush)
        l_ms = device_ms(lambda: torch.softmax(x, -1), flush=flush)
        bound, by, nbytes, ops = row_bound_ms('softmax', [x], x)
        log('  (r4) K5 at [%d, %d] f32 (block body): kernel %.4f ms, plain '
            '%.4f ms, torch.softmax %.4f ms, bound %.4f ms (%s: %.2f MB), '
            'bound / kernel %.3f' % (DECODE_CAPACITY, vocab, k_ms, p_ms, l_ms,
                                     bound, by, nbytes / 1e6, bound / k_ms))
        del flush
    return launches, {k: statistics.median(v) for k, v in sorted(ms.items())}


def ctc_ocr(device, batches=OCR_BATCHES):
    """Phase (r5): examples/ctc/lstm_ocr.py's recipe on the card (a
    bidirectional gluon.rnn.LSTM(48) over glyph columns, Dense to the 10
    digits and the blank, gluon.loss.CTCLoss(layout='TNC'), adam): the loss
    falling over a few batches; the CTC loss and its gradient on the card
    against the same call on the CPU."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.gluon import nn, rnn
    ctx = _ctx_of(device)
    ndigit, glyph_w, height, maxlen = 10, 3, 12, 5
    T = maxlen * glyph_w + 2
    rng = np.random.RandomState(2)
    glyphs = rng.randn(ndigit, glyph_w, height).astype(np.float32)
    n = batches * OCR_BATCH
    xs = np.zeros((n, T, height), np.float32)
    labels = np.full((n, maxlen), -1, np.float32)
    for i in range(n):
        digits = rng.randint(0, ndigit, rng.randint(3, maxlen + 1))
        for j, d in enumerate(digits):
            xs[i, 1 + j * glyph_w:1 + (j + 1) * glyph_w] = glyphs[d]
            labels[i, j] = d + 1                  # 0 is the CTC blank
        xs[i] += 0.1 * rng.randn(T, height)
    mt.random.seed(1)
    with mt.name.NameManager(), ctx:
        net = nn.Sequential()
        with net.name_scope():
            net.add(rnn.LSTM(48, num_layers=1, bidirectional=True))
            net.add(nn.Dense(ndigit + 1, flatten=False))
        net.initialize(mt.init.Xavier(), ctx=ctx)
        trainer = gluon.Trainer(net.collect_params(), 'adam',
                                {'learning_rate': 1e-2})
        ctc = gluon.loss.CTCLoss(layout='TNC', label_layout='NT')
        losses = []
        for b in range(batches):
            sl = slice(b * OCR_BATCH, (b + 1) * OCR_BATCH)
            data = nd.array(xs[sl].transpose(1, 0, 2), ctx=ctx)
            lab = nd.array(labels[sl], ctx=ctx)
            with autograd.record():
                loss = ctc(net(data), lab).mean()
            loss.backward()
            trainer.step(OCR_BATCH)
            losses.append(float(loss.asscalar()))
        logits = net(nd.array(xs[:OCR_BATCH].transpose(1, 0, 2), ctx=ctx))
    got = []
    for dev_ctx in (ctx, mt.cpu()):
        with dev_ctx:
            x = logits.as_in_context(dev_ctx).detach()
            x.attach_grad()
            with autograd.record():
                loss = ctc(x, nd.array(labels[:OCR_BATCH], ctx=dev_ctx))
            loss.backward()
            got.append((loss.handle.detach().cpu(),
                        x.grad.handle.detach().cpu()))
    (l_dev, g_dev), (l_cpu, g_cpu) = got
    l_err = float(((l_dev - l_cpu).abs() / l_cpu.abs()).max())
    g_exc = excess(g_dev, g_cpu, 0, CTC_RTOL)
    head, tail = np.mean(losses[:2]), np.mean(losses[-2:])
    log('  (r5) lstm_ocr\'s recipe (T %d, batch %d, bidirectional LSTM(48), '
        'CTCLoss(layout=TNC), adam): %d batches, loss %s (held falling); '
        'the CTC loss on %s against the CPU %.3e relative (held to %g), its '
        'gradient\'s excess %.3e (held to 1e-6)'
        % (T, OCR_BATCH, batches, ['%.3f' % v for v in losses], device,
           l_err, CTC_RTOL, g_exc))
    check(all(np.isfinite(losses)) and tail < head,
          '(r5) the CTC loss did not fall')
    check(l_err <= CTC_RTOL and g_exc <= 1e-6,
          '(r5) the CTC loss or its gradient disagrees with the CPU')


def phase_r(device, vocab=LM_VOCAB, sentences=None):
    """Phase (r): (r1) lstm_bucketing through BucketingModule.fit, (r2) the
    same on FusedRNNCell, (r3) Gluon's word LM with K3's held-out loss,
    (r4) DecodeEngine serving the LM's step through K5, (r5) lstm_ocr's CTC
    recipe. Returns {wrapper: launches} of (r3) and (r4) together."""
    t0 = time.perf_counter()
    log('  (r1) lstm_bucketing through BucketingModule.fit')
    init, trained, unrolled_ms = lm_bucketing(device, sentences, vocab)
    log('  (r2) the same on FusedRNNCell (the RNN op on cuDNN)')
    fused_lm(device, init, unrolled_ms, sentences, vocab)
    log('  (r3) Gluon\'s word language model')
    launches = word_lm(device, vocab)
    log('  (r4) DecodeEngine serving the language model\'s step')
    decode_launches, _ = decode_lm(device, trained, vocab)
    for k, v in decode_launches.items():
        launches[k] += v
    log('  (r5) lstm_ocr\'s CTC recipe')
    ctc_ocr(device)
    log('  phase (r) took %.1f s' % (time.perf_counter() - t0))
    return launches


# ---------------------------------------------------------------------------
# (s) the staged executor path: monitor, Custom ops, group2ctx, the NaN
#     bisect, the engine, print_summary
# ---------------------------------------------------------------------------

STAGED_BATCHES = 4      # (s1): train_imagenet's recipe, 4 batches of 32
STAGED_INTERVAL = 2     # Monitor(2): batches 1 and 3 are monitored
# (s2): the decoder head's probabilities and loss against the plain
# versions on the same tensors (as (n3) and (k2) hold them): f32, one
# kernel a row against torch's composite, max |error| 1e-5 and the
# loss's relative error EXEC_LOSS_RTOL
STAGED_PROB_ATOL = 1e-5
# (s3): the Custom op's gradients (softmax by K5, minus the one-hot, from
# its backward) against SoftmaxOutput(normalization='null')'s on the same
# parameters and batch: relative RMS 1e-5 (K5 and torch's softmax, one f32
# rounding apart an element)
CUSTOM_GRAD_REL_RMS = 1e-5
CUSTOM_BATCHES = 3
CUSTOM_LR = 1e-4        # the op's gradient is summed over 8192 rows
# (s4) model_parallel_lstm.py's symbol at lstm_bucketing's widths
MP_VOCAB, MP_EMBED, MP_HIDDEN, MP_BATCH, MP_SEQ, MP_LAYERS = \
    10000, 200, 200, 32, 35, 4
MP_STEPS = 4
MP_LR = 1.0
# layer 0 on the CPU, layers 1-3 on the card, against all on the card
# (TF32 off): the same f32 ops on two devices whose sums run in other
# orders; the outputs within relative RMS 1e-5, the gradients 1e-4
MP_OUT_REL_RMS = 1e-5
MP_GRAD_REL_RMS = 1e-4


def _recording_monitor(*args, **kwargs):
    """A Monitor of the port whose toc_print keeps its rows."""
    import mxnet_tpu_torch as mt

    class Recording(mt.mon.Monitor):
        def toc_print(self):
            self.rows.append(self.toc())
    mon = Recording(*args, **kwargs)
    mon.rows = []
    return mon


def _staged_counters():
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.ops import nvrtc
    return (ck.flash_fwd, ck.layernorm_fwd, ck.rmsnorm_fwd, ck.softmax_fwd,
            ck.softmax_xent_fwd, nvrtc.launch)


def _counts(counters):
    return {fwd.__name__: fwd.launches for fwd in counters}


def monitored_fit(device, spec=RESNET, n_batches=STAGED_BATCHES):
    """Phase (s1): (l1)'s recipe through Module.fit with
    Monitor(2, pattern='.*') and without one, from the same masters under
    cuDNN's deterministic algorithms. Returns the module (for (s5))."""
    import torch
    import mxnet_tpu_torch as mt
    name, batch, image, classes = spec
    ctx = mt.gpu(device.index or 0) if device.type == 'cuda' else mt.cpu()
    rng = np.random.RandomState(0)
    X = rng.standard_normal((n_batches * batch, 3, image, image)).astype(
        np.float32)
    y = rng.randint(0, classes, n_batches * batch).astype(np.int32)
    train = mt.io.NDArrayIter(X, y, batch_size=batch)
    mod = mt.mod.Module(_zoo_symbol(name, classes, (batch, 3, image, image)),
                        context=ctx)
    mod.bind(train.provide_data, train.provide_label)
    mt.random.seed(0)
    mod.init_params(_xavier())
    args, aux = mod.get_params()
    masters0 = {n: a.handle.detach().clone() for n, a in args.items()}
    aux0 = {n: a.handle.detach().clone() for n, a in aux.items()}
    exe = mod._exec_group.execs[0]
    n_rows = sum(n.opdef().n_visible_outputs(n.attrs)
                 for n in exe._prog.op_nodes) + len(exe._prog.arg_names)

    def one_fit(monitor):
        mod.set_params({n: mt.nd.from_torch(t.clone(), ctx)
                        for n, t in masters0.items()},
                       {n: mt.nd.from_torch(t.clone(), ctx)
                        for n, t in aux0.items()})
        mod.init_optimizer(kvstore='device', optimizer='sgd',
                           optimizer_params=FIT_OPT, force_init=True)
        train.reset()
        marks = []

        def mark(_):
            _sync(device)
            marks.append(time.perf_counter())
        with _flags_set(MXTPU_FUSED_FIT='0'):
            mt.random.seed(0)
            _sync(device)
            marks.append(time.perf_counter())
            mod.fit(train, num_epoch=1, optimizer='sgd',
                    optimizer_params=FIT_OPT, eval_metric=['acc'],
                    kvstore='device', batch_end_callback=mark,
                    monitor=monitor)
        a, x = mod.get_params()
        got = {n: v.handle.detach().clone()
               for n, v in list(a.items()) + list(x.items())}
        return got, list(np.diff(marks) * 1e3)

    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        one_fit(None)                                   # warm-up
        plain, plain_ms = one_fit(None)
        mon = _recording_monitor(STAGED_INTERVAL, pattern='.*')
        watched, mon_ms = one_fit(mon)
        again, again_ms = one_fit(None)
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    same = all(torch.equal(watched[n], plain[n]) for n in plain)
    same_again = all(torch.equal(again[n], plain[n]) for n in plain)
    log('  Module.fit of %s, %d batches of %d, with Monitor(%d, '
        "pattern='.*') and without: final parameters and aux states %s "
        '(a second plain fit: %s)'
        % (name, n_batches, batch, STAGED_INTERVAL,
           'bit for bit' if same else 'NOT bit for bit',
           'bit for bit' if same_again else 'NOT bit for bit'))
    check(same and same_again, 'the monitored fit\'s parameters differ')
    rows = [r for r in mon.rows if r]
    steps = sorted({s for batch_rows in rows for s, _, _ in batch_rows})
    stats = [float(stat.split('\t')[0]) for batch_rows in rows
             for _, _, stat in batch_rows]
    log('  monitored batches %s: %s rows each (%d op outputs and arguments '
        'in the graph), RMS from %.4g to %.4g, all finite: %s'
        % (steps, [len(r) for r in rows], n_rows, min(stats), max(stats),
           all(math.isfinite(v) for v in stats)))
    check(steps == list(range(1, n_batches + 1, STAGED_INTERVAL)),
          'the monitor\'s windows are %s' % steps)
    check(all(len(r) == n_rows for r in rows), 'a monitored batch has %s '
          'rows, not %d' % ([len(r) for r in rows], n_rows))
    check(all(math.isfinite(v) for v in stats), 'a monitored RMS is not '
          'finite')
    log('  a batch\'s host ms (synchronised): monitored %s (batches 1, 3), '
        'unmonitored in the same fit %s; plain fits %s and %s'
        % (['%.3f' % mon_ms[i] for i in (0, 2)],
           ['%.3f' % mon_ms[i] for i in (1, 3)],
           ['%.3f' % v for v in plain_ms], ['%.3f' % v for v in again_ms]))
    # (s5) bisects from the initial parameters
    mod.set_params({n: mt.nd.from_torch(t.clone(), ctx)
                    for n, t in masters0.items()},
                   {n: mt.nd.from_torch(t.clone(), ctx)
                    for n, t in aux0.items()})
    return mod, {'monitored_ms': [mon_ms[0], mon_ms[2]],
                 'plain_ms': [statistics.median(plain_ms[1:]),
                              statistics.median(again_ms[1:])]}


def _head_symbol(mt, V, custom=None):
    """LayerNorm -> FullyConnected(V, no bias) -> softmax beside
    softmax_cross_entropy (``custom``: the op_type of a Custom op in the
    softmax's place, under the name softmax, with its label)."""
    S = mt.sym
    logits = S.FullyConnected(S.LayerNorm(S.var('x'), name='ln'),
                              num_hidden=V, no_bias=True, name='head')
    if custom == 'null':
        return S.SoftmaxOutput(logits, normalization='null', name='softmax')
    if custom is not None:
        return S.Custom(data=logits, name='softmax', op_type=custom)
    return S.Group([S.softmax(logits, name='prob'),
                    S.softmax_cross_entropy(logits, S.var('label'),
                                            name='xent')])


def _head_values(device, N, D, V, seed):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    vals = {'x': torch.randn(N, D, generator=g, device=device),
            'ln_gamma': 1 + 0.1 * torch.randn(D, generator=g, device=device),
            'ln_beta': 0.1 * torch.randn(D, generator=g, device=device),
            'head_weight': torch.randn(V, D, generator=g, device=device)
            / math.sqrt(D)}
    label = torch.randint(0, V, (N,), generator=g, device=device,
                          dtype=torch.int32)
    return vals, label


def staged_head(device, cfg):
    """Phase (s2): the decoder head through the staged path, a monitor
    installed. Returns {wrapper: launches}."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    N, D, V = MAX_BATCH * cfg.seq_len, cfg.d_model, cfg.vocab
    ctx = mt.gpu(device.index or 0) if device.type == 'cuda' else mt.cpu()
    sym = _head_symbol(mt, V)
    reqs = {'x': 'write', 'ln_gamma': 'write', 'ln_beta': 'write',
            'head_weight': 'write', 'label': 'null'}
    ex = sym.simple_bind(ctx, grad_req=reqs, type_dict={'label': 'int32'},
                         x=(N, D), label=(N,))
    vals, label = _head_values(device, N, D, V, 31)
    for n, v in vals.items():
        ex.arg_dict[n]._data = v
    ex.arg_dict['label']._data = label
    mon = _recording_monitor(1, pattern='.*')
    mon.install(ex)

    def run():
        out = ex.forward(is_train=True)
        ex.backward()
        outs = [o.handle.clone() for o in out]
        return outs, {n: ex.grad_dict[n].handle.clone() for n in vals}

    counters = _staged_counters()
    _zero_counts(counters)          # the main path: the monitored run
    mon.tic()
    outs, grads = run()
    mon.toc_print()
    _sync(device)
    launches = _counts(counters)
    want = {'flash_fwd': 0, 'layernorm_fwd': 1, 'rmsnorm_fwd': 0,
            'softmax_fwd': 1, 'softmax_xent_fwd': 1, 'launch': 0}
    if device.type != 'cuda':
        want = dict.fromkeys(want, 0)
    names = [n for _, n, _ in mon.rows[0]]
    log('  simple_bind(x [%d, %d] f32 -> LayerNorm -> FullyConnected to %d '
        '-> softmax, softmax_cross_entropy beside it) on %s, Monitor(1) '
        'installed: forward(is_train=True) and backward, launches %s; the '
        'monitor\'s rows %s' % (N, D, V, ctx, launches, names))
    check(launches == want, 'staged launches %s != %s' % (launches, want))
    check(names == ['ln_output', 'head_output', 'prob_output', 'xent_output',
                    'x', 'ln_gamma', 'ln_beta', 'head_weight', 'label'],
          'the monitor\'s rows are %s' % names)
    ex.set_monitor_callback(None)
    plain_outs, plain_grads = run()
    same = all(torch.equal(a, b) for a, b in zip(outs, plain_outs)) and \
        all(torch.equal(grads[n], plain_grads[n]) for n in grads)
    log('  the same executor without the monitor: outputs and gradients %s'
        % ('bit for bit' if same else 'NOT bit for bit'))
    check(same, 'the monitored head differs from the plain one')
    step, left = 0, ex.partial_forward(False, 0)
    while left:
        step += 1
        left = ex.partial_forward(False, step)
    stepped = [o.handle.clone() for o in ex.outputs]
    full = [o.handle for o in ex.forward(is_train=False)]
    same = all(torch.equal(a, b) for a, b in zip(stepped, full))
    log('  partial_forward stepped %d times to 0 left: outputs %s forward\'s'
        % (step + 1, 'bit for bit' if same else 'NOT bit for bit'))
    check(same and step + 1 == len(ex._prog.op_nodes),
          'partial_forward disagrees with forward')
    with torch.no_grad():
        z = ck.layernorm_ref(vals['x'], vals['ln_gamma'], vals['ln_beta']) \
            @ vals['head_weight'].t()
        p_err = float((outs[0] - ck.softmax_ref(z)).abs().max())
        ref_loss = float(ck.softmax_xent_ref(z, label).sum())
    loss_err = abs(float(outs[1].sum()) - ref_loss) / abs(ref_loss)
    log('  probabilities max |error| %.3e against the plain versions (atol '
        '%.0e); loss %.4f against %.4f (relative error %.3e)'
        % (p_err, STAGED_PROB_ATOL, float(outs[1].sum()), ref_loss, loss_err))
    check(p_err <= STAGED_PROB_ATOL, 'the staged probabilities disagree')
    check(loss_err <= EXEC_LOSS_RTOL, 'the staged loss disagrees')
    return launches


def _card_softmax_op(mt):
    """custom_softmax.py's Softmax with its forward over nd.softmax (K5 on
    the card) and its backward on the card: softmax minus the one-hot."""
    class Softmax(mt.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], mt.nd.softmax(in_data[0]))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            onehot = mt.nd.one_hot(in_data[1], depth=in_data[0].shape[1])
            self.assign(in_grad[0], req[0], out_data[0] - onehot)

    @mt.operator.register('card_softmax')
    class SoftmaxProp(mt.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ['data', 'label']

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()


def _card_ce():
    """A metric of the mean -log p at the label, computed on the card (the
    host reads one number a batch, not the [8192, 16384] probabilities)."""
    import torch
    import mxnet_tpu_torch as mt

    class CardCE(mt.metric.EvalMetric):
        def update(self, labels, preds):
            p = preds[0].handle
            lab = labels[0].handle.to(p.device).long()
            self.sum_metric += float(
                -torch.log(p.gather(1, lab[:, None])).mean())
            self.num_inst += 1
    return CardCE('card-ce')


def custom_head(device, cfg, batches=CUSTOM_BATCHES):
    """Phase (s3): (s2)'s head under a Custom softmax through Module.fit,
    its gradient against SoftmaxOutput(normalization='null')'s, and a
    NumpyOp and an NDArrayOp at a small width. Returns {wrapper:
    launches} of the fit."""
    import torch
    import mxnet_tpu_torch as mt
    N, D, V = MAX_BATCH * cfg.seq_len, cfg.d_model, cfg.vocab
    ctx = mt.gpu(device.index or 0) if device.type == 'cuda' else mt.cpu()
    _card_softmax_op(mt)
    vals, label = _head_values(device, N, D, V, 41)
    grads = {}
    for kind in ('card_softmax', 'null'):
        sym = _head_symbol(mt, V, custom=kind)
        ex = sym.simple_bind(ctx, grad_req={'x': 'null', 'ln_gamma': 'write',
                                            'ln_beta': 'write',
                                            'head_weight': 'write',
                                            'softmax_label': 'null'},
                             x=(N, D), softmax_label=(N,))
        for n, v in vals.items():
            ex.arg_dict[n]._data = v
        ex.arg_dict['softmax_label']._data = label.float()
        ex.forward(is_train=True)
        ex.backward()
        grads[kind] = {n: ex.grad_dict[n].handle.clone()
                       for n in ('ln_gamma', 'ln_beta', 'head_weight')}
        del ex
    errs = {n: rel_rms(grads['card_softmax'][n], grads['null'][n])
            for n in grads['null']}
    log('  Custom(op_type=card_softmax: nd.softmax forward, softmax minus '
        'one-hot backward) against SoftmaxOutput(normalization=\'null\') on '
        '[%d, %d] f32 logits: gradients relative RMS %s (bound %.0e)'
        % (N, V, ', '.join('%s %.3e' % kv for kv in errs.items()),
           CUSTOM_GRAD_REL_RMS))
    check(max(errs.values()) <= CUSTOM_GRAD_REL_RMS,
          'the Custom op\'s gradients disagree')

    g = torch.Generator().manual_seed(43)
    X = torch.randn(batches * N, D, generator=g).numpy()
    Y = torch.randint(0, V, (batches * N,), generator=g).float().numpy()
    train = mt.io.NDArrayIter(X, Y, batch_size=N, data_name='x',
                              label_name='softmax_label')
    mod = mt.mod.Module(_head_symbol(mt, V, custom='card_softmax'),
                        data_names=['x'], context=ctx)
    losses = []

    def per_batch(param):
        losses.append(param.eval_metric.get()[1])
        param.eval_metric.reset()
    counters = _staged_counters()
    _zero_counts(counters)          # the main path: the fit
    mod.fit(train, num_epoch=1, optimizer='sgd',
            optimizer_params={'learning_rate': CUSTOM_LR},
            eval_metric=_card_ce(), batch_end_callback=per_batch,
            arg_params={n: mt.nd.from_torch(v.clone(), ctx)
                        for n, v in vals.items() if n != 'x'})
    _sync(device)
    launches = _counts(counters)
    want = {'flash_fwd': 0, 'layernorm_fwd': batches, 'rmsnorm_fwd': 0,
            'softmax_fwd': batches, 'softmax_xent_fwd': 0, 'launch': 0}
    if device.type != 'cuda':
        want = dict.fromkeys(want, 0)
    log('  Module.fit(LayerNorm -> FullyConnected to %d -> Custom '
        'card_softmax) on %s, %d batches of %d, the per-batch loop: mean '
        '-log p %s, launches %s'
        % (V, ctx, batches, N, ['%.4f' % v for v in losses], launches))
    check(launches == want, 'custom launches %s != %s' % (launches, want))
    check(all(math.isfinite(v) for v in losses), 'a Custom loss is not '
          'finite')
    check(mod.__dict__.get('_fused_fit_cache') is None,
          'a fused window was built for a graph with a host op')
    del mod

    class Scale3(mt.operator.NumpyOp):
        def forward(self, in_data, out_data):
            out_data[0][:] = in_data[0] * 3

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = out_grad[0] * 3

    class Sq(mt.operator.NDArrayOp):
        def forward(self, in_data, out_data):
            out_data[0][:] = in_data[0] * in_data[0]

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = 2 * in_data[0] * out_grad[0]
    x = torch.randn(16, 32, generator=torch.Generator().manual_seed(5))
    for op, f, df in ((Scale3(), lambda t: 3 * t, lambda t: 3 + 0 * t),
                      (Sq(), lambda t: t * t, lambda t: 2 * t)):
        ex = op(mt.sym.var('data')).simple_bind(ctx, data=(16, 32))
        ex.arg_dict['data']._data = x.to(device)
        out = ex.forward(is_train=True)[0]
        ex.backward(mt.nd.ones((16, 32), ctx))
        o_err = float((out.handle.cpu() - f(x)).abs().max())
        g_err = float((ex.grad_dict['data'].handle.cpu() - df(x)).abs().max())
        log('  %s on [16, 32] f32 through simple_bind on %s: output on %s, '
            'max |error| %.3e, gradient %.3e'
            % (type(op).__bases__[0].__name__, ctx, out.handle.device, o_err,
               g_err))
        check(out.handle.device.type == device.type and o_err <= 1e-6
              and g_err <= 1e-6, '%s disagrees' % type(op).__name__)
    return launches


def _mp_lstm(mt, group2ctx):
    """examples/rnn/model_parallel_lstm.py's build_symbol, with the layers'
    ctx_group attrs when ``group2ctx`` is given."""
    import contextlib
    S = mt.sym

    def scope(i):
        return mt.AttrScope(ctx_group='layer%d' % i) if group2ctx \
            else contextlib.nullcontext()
    data = S.Variable('data')
    label = S.Variable('softmax_label')
    with scope(0):
        hidden = S.Embedding(data=data, input_dim=MP_VOCAB,
                             output_dim=MP_EMBED, name='embed')
    for i in range(MP_LAYERS):
        with scope(i):
            cell = mt.rnn.LSTMCell(num_hidden=MP_HIDDEN,
                                   prefix='lstm_l%d_' % i)
            hidden, _ = cell.unroll(MP_SEQ, inputs=hidden,
                                    merge_outputs=True, layout='NTC')
    with scope(MP_LAYERS - 1):
        pred = S.Reshape(hidden, shape=(-1, MP_HIDDEN))
        pred = S.FullyConnected(data=pred, num_hidden=MP_VOCAB, name='pred')
        out = S.SoftmaxOutput(data=pred, label=S.Reshape(label, shape=(-1,)),
                              normalization='batch', name='softmax')
    return out


def model_parallel(device):
    """Phase (s4): model_parallel_lstm.py's symbol with layer 0 on cpu(0)
    and layers 1-3 on the card, against the same graph on the card alone,
    then a few SGD steps."""
    import torch
    import mxnet_tpu_torch as mt
    on_card = device.type == 'cuda'
    card = mt.gpu(device.index or 0) if on_card else mt.cpu(1)
    group2ctx = {'layer0': mt.cpu(0)}
    group2ctx.update({'layer%d' % i: card for i in range(1, MP_LAYERS)})
    rng = np.random.RandomState(0)
    trans = np.random.RandomState(42).dirichlet(np.ones(MP_VOCAB) * 0.02,
                                                size=MP_VOCAB)
    x = np.zeros((MP_BATCH, MP_SEQ), np.float32)
    x[:, 0] = rng.randint(1, MP_VOCAB, MP_BATCH)
    cum = trans.cumsum(1)
    for t in range(1, MP_SEQ):
        u = rng.random_sample(MP_BATCH)
        x[:, t] = (cum[x[:, t - 1].astype(int)] < u[:, None]).sum(1)
    y = np.roll(x, -1, axis=1)
    y[:, -1] = 0
    runs = {}
    values = None
    for kind, g2c in (('split', group2ctx), ('card', None)):
        sym = _mp_lstm(mt, g2c)
        shapes = dict(data=(MP_BATCH, MP_SEQ),
                      softmax_label=(MP_BATCH, MP_SEQ))
        arg_shapes, _, _ = sym.infer_shape(**shapes)
        names = sym.list_arguments()
        if values is None:
            mt.random.seed(0)
            init = mt.init.Xavier()
            values = {}
            for n, s in zip(names, arg_shapes):
                if n in ('data', 'softmax_label'):
                    continue
                a = mt.nd.zeros(s, ctx=mt.cpu())
                init(mt.init.InitDesc(n), a)
                values[n] = a.handle
        args = {n: mt.nd.from_torch(values[n].to(card.torch_device()), card)
                for n in values}
        args['data'] = mt.nd.array(x, card)
        args['softmax_label'] = mt.nd.array(y, card)
        grads = {n: mt.nd.zeros(args[n].shape, card) for n in values}
        ex = sym.bind(card, args, args_grad=grads, group2ctx=g2c)
        where = {}
        ex.set_monitor_callback(
            lambda n, a: where.setdefault(n, a.handle.device.type))
        out = ex.forward(is_train=True)[0]
        ex.backward()
        runs[kind] = (ex, out.handle.detach().clone(),
                      {n: g.handle.clone() for n, g in grads.items()}, where)
        log('  %s: %d graph nodes%s' % (
            kind, len(ex._prog.topo), ', groups %s' % {
                k: str(v) for k, v in g2c.items()} if g2c else ''))
    ex, out, grads, where = runs['split']
    _, out_c, grads_c, _ = runs['card']
    o_err = rel_rms(out.to(out_c.device), out_c)
    g_errs = {n: rel_rms(grads[n].to(grads_c[n].device), grads_c[n])
              for n in grads}
    worst = max(g_errs, key=g_errs.get)
    log('  layer 0 on cpu(0), layers 1-3 on %s, against all on %s: outputs '
        'relative RMS %.3e (bound %.0e), gradients up to %.3e (%s; bound '
        '%.0e)' % (card, card, o_err, MP_OUT_REL_RMS, g_errs[worst], worst,
                   MP_GRAD_REL_RMS))
    check(o_err <= MP_OUT_REL_RMS, 'the split LSTM\'s outputs disagree')
    check(g_errs[worst] <= MP_GRAD_REL_RMS, 'the split LSTM\'s gradients '
          'disagree')
    group = {n.name: n.attr_dict.get('ctx_group')
             for n in ex._prog.op_nodes}
    want = {n: group2ctx[group[n.rsplit('_output', 1)[0]]].torch_device(
        ).type for n in where}
    bad = [n for n in where if where[n] != want[n]]
    log('  each group\'s outputs on its device: %d op outputs, layer 0\'s on '
        'cpu, the others on %s; misplaced %s'
        % (len(where), card.torch_device().type, bad))
    check(not bad and out.device.type == card.torch_device().type,
          'outputs misplaced: %s' % bad[:5])
    ex.set_monitor_callback(None)
    losses = []
    yi = torch.from_numpy(y.reshape(-1).astype(np.int64))
    for _ in range(MP_STEPS):
        p = ex.forward(is_train=True)[0].handle
        losses.append(float(-torch.log(
            p.gather(1, yi.to(p.device)[:, None])).mean()))
        ex.backward()
        for n in values:
            w = ex.arg_dict[n]
            w._data = w.handle - MP_LR * ex.grad_dict[n].handle
    log('  SGD (lr %g) on one batch: loss %s'
        % (MP_LR, ['%.4f' % v for v in losses]))
    check(losses[-1] < losses[0], 'the split LSTM\'s loss does not fall')


def nan_bisect(device, mod):
    """Phase (s5): one of (s1)'s ResNet-50 convolution weights set to NaN:
    first_nonfinite_node names it, and Monitor.nan_watch's rows flag it."""
    import mxnet_tpu_torch as mt
    ex = mod._exec_group.execs[0]
    convs = [n for n in ex._prog.op_nodes if n.op == 'Convolution']
    conv = convs[len(convs) // 2]
    wname = conv.inputs[1][0].name
    w = ex.arg_dict[wname]
    keep = w.handle.clone()
    bad = keep.clone()
    bad.view(-1)[7] = float('nan')
    w._data = bad
    try:
        t0 = time.perf_counter()
        found = ex.first_nonfinite_node(is_train=False)
        bisect_s = time.perf_counter() - t0
        mon = mt.mon.Monitor.nan_watch(1, pattern='%s|%s_output'
                                       % (wname, conv.name))
        mon.install(ex)
        mon.tic()
        ex.forward(is_train=False)
        rows = mon.toc()
        ex.set_monitor_callback(None)
    finally:
        w._data = keep
    flagged = {n: s.strip() for _, n, s in rows}
    log('  NaN in %s (element 7 of %s): first_nonfinite_node -> %s in %.2f '
        's; nan_watch rows %s' % (wname, tuple(keep.shape), found, bisect_s,
                                   flagged))
    check(found == (wname, 0), 'the bisect named %s' % (found,))
    check(flagged.get(wname) == 'nan=1 inf=0 of %d' % keep.numel()
          and flagged.get(conv.name + '_output', 'ok') != 'ok',
          'nan_watch did not flag %s' % wname)


def engine_checks(device, work):
    """Phase (s6): the native engine's order, wait_for_all over the card,
    and its op spans in a profiler dump."""
    import threading
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import engine
    eng = engine.Engine(num_workers=4)
    a, b = eng.new_var(), eng.new_var()
    log_ = []
    lock = threading.Lock()

    def ev(tag, pause=0.0):
        def fn():
            if pause:
                time.sleep(pause)
            with lock:
                log_.append(tag)
        return fn
    for i in range(4):
        eng.push(ev('w%d' % i, 0.004 * (4 - i)), mutable_vars=[a])
        eng.push(ev('r%d' % i), const_vars=[a])
        eng.push(ev('r%d' % i), const_vars=[a])
    eng.push(ev('both'), mutable_vars=[a, b])
    eng.push(ev('last'), const_vars=[b])
    eng.wait_for_var(b)
    want = [t for i in range(4) for t in ('w%d' % i, 'r%d' % i, 'r%d' % i)]
    log('  native engine (src/engine.cc, 4 workers): %s' % log_)
    check(log_ == want + ['both', 'last'], 'the engine\'s order is %s' % log_)
    x = torch.randn(4096, 4096, device=device)
    for _ in range(20):
        x = x @ x.t() * 1e-4
    engine.wait_for_all()
    idle = device.type != 'cuda' or torch.cuda.current_stream(device).query()
    log('  engine.wait_for_all after 20 queued 4096^2 matmuls: the card\'s '
        'stream idle: %s' % idle)
    check(idle, 'wait_for_all returned before the card finished')
    path = os.path.join(work, 'engine_profile.json')
    with mt.profiler.Profiler(mode='all', filename=path):
        v = eng.new_var()
        for i in range(3):
            eng.push(lambda: time.sleep(0.001), mutable_vars=[v],
                     name='engine_op_%d' % i)
        eng.wait_for_all()
    with open(path) as f:
        events = json.load(f)['traceEvents']
    spans = sorted(e['name'] for e in events
                   if e['name'].startswith('engine_op_'))
    log('  profiler dump %s: %d events, engine op spans %s'
        % (os.path.basename(path), len(events), spans))
    check(spans == ['engine_op_0', 'engine_op_1', 'engine_op_2'],
          'the profiler dump lacks the engine\'s spans')
    eng.close()


def summary_resnet50():
    """Phase (s7): print_summary of resnet50_v1 at 224."""
    import contextlib
    import io
    import mxnet_tpu_torch as mt
    sym = _zoo_symbol('resnet50_v1', 1000, (1, 3, 224, 224))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mt.viz.print_summary(sym, shape={'data': (1, 3, 224, 224)})
    text = buf.getvalue()
    total = int(text.split('Total params: ')[1].split()[0])
    # the Param # column (characters 76-88 of a 120-wide row)
    column = sum(int(line[76:88]) for line in text.splitlines()
                 if line[76:88].strip().isdigit())
    args, _, _ = sym.infer_shape(data=(1, 3, 224, 224))
    n_params = sum(int(np.prod(s)) for n, s in zip(sym.list_arguments(), args)
                   if n not in ('data', 'softmax_label'))
    log('  print_summary(resnet50_v1, data 1 x 3 x 224 x 224): %d lines, '
        'Total params: %d, the sum of its Param # column; the symbol\'s '
        'parameters hold %d (the summary adds each weight input\'s second '
        'dimension to a layer\'s input channels, as the JAX package\'s '
        'does)' % (len(text.splitlines()), total, n_params))
    check(total == column and total > n_params,
          'print_summary\'s total %d, its column %d' % (total, column))


def phase_s(device, cfg, work):
    """Phase (s): (s1) the monitored fit, (s2) the head on the staged path,
    (s3) a Custom op on the card, (s4) group2ctx, (s5) the NaN bisect, (s6)
    the engine, (s7) print_summary. Returns ({wrapper: staged launches},
    {wrapper: custom launches}, (s1)'s batch times)."""
    t0 = time.perf_counter()
    log('  (s1) train_imagenet\'s recipe through Module.fit with a monitor')
    mod, times_ = monitored_fit(device)
    log('  (s5) the NaN bisect on (s1)\'s ResNet-50')
    nan_bisect(device, mod)
    del mod
    log('  (s2) the decoder head through the staged path')
    staged = staged_head(device, cfg)
    log('  (s3) a Custom op on the card')
    custom = custom_head(device, cfg)
    log('  (s4) group2ctx: model_parallel_lstm.py at lstm_bucketing\'s '
        'widths')
    model_parallel(device)
    log('  (s6) the native engine')
    engine_checks(device, work)
    log('  (s7) print_summary')
    summary_resnet50()
    log('  phase (s) took %.1f s' % (time.perf_counter() - t0))
    return staged, custom, times_


# ---------------------------------------------------------------------------
# (t) sparse storage and the contrib detection and vision ops
# ---------------------------------------------------------------------------

SVM_FEATURES = 1_000_000    # Avazu's width
SVM_BATCH = 256
SVM_BATCHES = 32            # 8,192 rows of the generated libsvm file
SVM_EPOCHS = 2              # two passes: the second sees the same rows
SVM_LR = 1.0                # examples/sparse/linear_classification.py's
SVM_MODULE_BATCHES = 4      # the reference script's Module form
SVM_MODULE_CPU = 2          # its batches held against the CPU
SPARSE_CLASSES = 128        # (t3): W [1,000,000, 128] f32
SPARSE_LR = 100.0           # on the batch mean: about 0.4 a sample
# f32 values on the card against the port on the CPU, |card - cpu| <= rtol
# x the largest |cpu| value: index_add_ sums in another order on the card
# (atomics), cuDNN's and cuBLAS's f32 sums too
SPARSE_RTOL = 1e-5
CONTRIB_RTOL = 1e-5
CONTRIB_GRAD_RTOL = 1e-4
SQUARE_SUM_RTOL = 1e-6      # a reduction of f32 squares in another order
# SSD300 (Liu et al. 2016), as MXNet's example/ssd configures VGG16 at 300:
# six maps, 4, 6, 6, 6, 4 and 4 anchors a position, 8,732 anchors
SSD300_MAPS = (38, 19, 10, 5, 3, 1)
SSD300_SIZES = ((.1, .141), (.2, .272), (.37, .447), (.54, .619),
                (.71, .79), (.88, .961))
SSD300_RATIOS = ((1, 2, .5), (1, 2, .5, 3, 1. / 3), (1, 2, .5, 3, 1. / 3),
                 (1, 2, .5, 3, 1. / 3), (1, 2, .5), (1, 2, .5))
SSD300_STEPS = (8, 16, 32, 64, 100, 300)
SSD_CLASSES = 21            # VOC's 20 and the background
SSD_BATCH = 32
SSD_MAX_OBJECTS = 16
SSD_CPU_SAMPLES = 2         # MultiBoxDetection works a sample at a time:
                            # the CPU holds the batch's first samples
SSD_IOU_CPU_ROWS = 1024     # box_iou's rows held against the CPU
# examples/ssd/train_ssd.py at its own sizes
SSD_IMG, SSD_FG, SSD_OBJS = 64, 3, 4
SSD_SAMPLES, SSD_EX_BATCH, SSD_EPOCHS, SSD_EX_LR = 128, 16, 2, 0.05
# Faster R-CNN (Ren et al. 2015): VGG16's conv5 at stride 16 on two
# 600 x 1000 images, 9 anchors, the op's reference defaults
RPN_MAP = (38, 63)
RPN_IMAGES = 2
RPN_SCALES = (8.0, 16.0, 32.0)
RPN_RATIOS = (0.5, 1.0, 2.0)
ROI_CHANNELS = 512
ROI_CPU = 32                # rois held against the CPU, forward and backward
# examples/rcnn/train_rcnn_lite.py at its own sizes
RCNN_IMG, RCNN_STRIDE, RCNN_SCALES, RCNN_FG = 64, 8, (2.0, 4.0), 3
RCNN_SAMPLES, RCNN_BATCH, RCNN_RPN_EPOCHS, RCNN_HEAD_EPOCHS = 48, 8, 5, 20
RCNN_LR = 0.005
# R-FCN (Dai et al. 2016) and its deformable form (Dai et al. 2017)
RFCN_DIM, RFCN_GROUP, RFCN_SPP, RFCN_TSTD = 21, 7, 4, 0.1
DEFORM_SHAPE = (2, 512, 38, 63)     # res5 of Dai et al. 2017
DEFORM_CPU = 1                      # samples held against the CPU
FLOW_SHAPE = (4, 256, 48, 64)       # FlowNetC's correlation
FLOW_DISP, FLOW_STRIDE2 = 20, 2
FLOW_CPU = 1
STN_SHAPE = (32, 3, 224, 224)
STN_CPU = 2
FFT_SHAPE = (256, 4096)
SKETCH_SHAPE, SKETCH_DIM = (4096, 512), 8192
KL_SHAPE = (256, 1024)
QUANT_MLP = (768, 8, 48, 8)         # quantize_mlp.py: samples, classes, dim, epochs


def _held(got, want, rtol, what):
    """``got`` (the card's) against ``want`` (the CPU's): integer and bool
    tensors exactly, floats within rtol x the largest |want| value. Returns
    the largest |got - want|."""
    import torch
    got, want = got.detach().cpu(), want.detach().cpu()
    check(tuple(got.shape) == tuple(want.shape),
          '%s: shape %s, on the CPU %s' % (what, tuple(got.shape),
                                          tuple(want.shape)))
    if not want.is_floating_point():
        check(torch.equal(got, want), '%s differs from the CPU' % what)
        return 0.0
    if want.numel() == 0:
        return 0.0
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    check(err <= rtol * scale, '%s: max |card - cpu| %.3e over %.0e x %.4g'
          % (what, err, rtol, scale))
    return err


def _exact(got, want, what):
    """Bit for bit (floats compared as their bits, NaN and -0 included)."""
    import torch
    got, want = got.detach().cpu(), want.detach().cpu()
    ok = tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype
    if ok and got.is_floating_point():
        ok = torch.equal(got.view(torch.int32) if got.dtype == torch.float32
                         else got, want.view(torch.int32)
                         if want.dtype == torch.float32 else want)
    elif ok:
        ok = torch.equal(got, want)
    check(ok, '%s is not bit for bit the CPU\'s' % what)


def _wall_ms(fn, device, runs=5):
    """Median synchronised host ms of ``fn()`` (for work that reads a size
    back from the device inside, where CUDA events would time the host's
    wait)."""
    fn()
    _sync(device)
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def write_avazu_libsvm(path, rows, nfeat=SVM_FEATURES, seed=3):
    """The Avazu-shaped generator of tests/compat/test_reference_scripts.py
    (10-30 distinct sorted features a row, each a value in [0, 1), the
    label from the share of features in the lower half plus noise). A row's
    distinct features are drawn by rejection, not by a permutation of all
    the features a row, which costs 8 ms a row at 1,000,000."""
    rng = np.random.RandomState(seed)
    lines = []
    for _ in range(rows):
        nnz = rng.randint(10, 30)
        while True:
            idx = np.unique(rng.randint(0, nfeat, nnz))
            if len(idx) == nnz:
                break
        sig = (idx < nfeat // 2).sum() - nnz / 2.0
        label = 1 if sig + rng.randn() * 2 > 0 else 0
        vals = rng.rand(nnz)
        lines.append('%d %s\n' % (label, ' '.join(
            '%d:%.4f' % (j, v) for j, v in zip(idx, vals))))
    with open(path, 'w') as f:
        f.writelines(lines)


def _svm_iter(mt, path, batch=None):
    return mt.io.LibSVMIter(data_libsvm=path, data_shape=(SVM_FEATURES,),
                            batch_size=batch or SVM_BATCH)


def linear_recipe(device, path):
    """examples/sparse/linear_classification.py's loop on ``device``: the
    CSR batch through nd.sparse.dot, the logistic loss, the transposed
    sparse dot's row_sparse gradient, the dense update. Returns (mean log
    loss an epoch, synchronised host ms a batch, w, b)."""
    import mxnet_tpu_torch as mt
    with _ctx_of(device):
        it = _svm_iter(mt, path)
        w = mt.nd.zeros((SVM_FEATURES, 1))
        b = mt.nd.zeros((1,))
        losses, ms = [], []
        for _ in range(SVM_EPOCHS):
            it.reset()
            tot, seen = 0.0, 0
            for batch in it:
                t0 = time.perf_counter()
                data, lab = batch.data[0], batch.label[0]
                n = data.shape[0]
                z = mt.nd.sparse.dot(data, w).reshape((-1,)) + b
                p = 1.0 / (1.0 + (-z).exp())
                err = p - lab
                gw = (1.0 / n) * mt.nd.sparse.dot(data, err.reshape((-1, 1)),
                                                  transpose_a=True)
                check(gw.stype == 'row_sparse', 'the transposed dot gave %s'
                      % gw.stype)
                w = w - (SVM_LR * gw).tostype('default')
                b -= SVM_LR * err.mean()
                eps = 1e-7
                tot += float((-(lab * (p + eps).log() + (1 - lab) *
                                (1 - p + eps).log())).sum().asscalar())
                ms.append((time.perf_counter() - t0) * 1e3)
                seen += n
            losses.append(tot / seen)
    return losses, ms, w, b


def sparse_module(device, path, batches):
    """The reference script's Module form: a csr ``data`` Variable,
    sym.sparse.dot with a row_sparse ``weight``, a logistic output, a local
    kvstore and kv.row_sparse_pull(row_ids=batch.data[0].indices) before
    each batch. Returns (each batch's output on the host, synchronised host
    ms a batch, the parameters)."""
    import mxnet_tpu_torch as mt
    ctx = _ctx_of(device)
    data = mt.sym.Variable('data', stype='csr')
    weight = mt.sym.Variable('weight', shape=(SVM_FEATURES, 1),
                             stype='row_sparse')
    bias = mt.sym.Variable('bias', shape=(1,))
    pred = mt.sym.broadcast_add(mt.sym.sparse.dot(data, weight), bias)
    net = mt.sym.LogisticRegressionOutput(
        pred.reshape((-1,)), mt.sym.Variable('softmax_label'), name='out')
    with ctx:
        it = _svm_iter(mt, path)
        mod = mt.mod.Module(net, data_names=['data'],
                            label_names=['softmax_label'], context=ctx)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        rng = np.random.RandomState(5)
        mod.init_params(arg_params={
            'weight': mt.nd.array(0.01 * rng.randn(SVM_FEATURES, 1).astype(
                np.float32)), 'bias': mt.nd.zeros((1,))})
        kv = mt.kv.create('local')
        mod.init_optimizer(kvstore=kv, optimizer='sgd', optimizer_params={
            'learning_rate': 0.1, 'rescale_grad': 1.0 / SVM_BATCH})
        widx = mod._exec_group.param_names.index('weight')
        outs, ms = [], []
        for k, batch in enumerate(it):
            if k == batches:
                break
            t0 = time.perf_counter()
            kv.row_sparse_pull('weight', mod._exec_group.param_arrays[widx],
                               row_ids=batch.data[0].indices)
            mod.forward_backward(batch)
            mod.update()
            out = mod.get_outputs()[0].handle
            _sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(out.detach().cpu())
        args, _ = mod.get_params()
    return outs, ms, {k: v.handle.detach().cpu() for k, v in args.items()}


def sparse_classifier(device, work):
    """Phase (t1): returns the generated file's path and the first batch's
    CSR on the card."""
    import torch
    import mxnet_tpu_torch as mt
    path = os.path.join(work, 'avazu.libsvm')
    t0 = time.perf_counter()
    write_avazu_libsvm(path, SVM_BATCH * SVM_BATCHES, SVM_FEATURES)
    log('    wrote %d rows of %d features: %.1f s'
        % (SVM_BATCH * SVM_BATCHES, SVM_FEATURES, time.perf_counter() - t0))
    losses, ms, w, b = linear_recipe(device, path)
    log('    example recipe on the card: log loss %s an epoch; %.3f ms a '
        'batch (median of %d, synchronised host wall, LibSVMIter\'s batch '
        'upload outside)' % (', '.join('%.5f' % l for l in losses),
                             statistics.median(ms), len(ms)))
    check(losses[-1] < losses[0], 'the log loss did not fall: %s' % losses)
    cpu = torch.device('cpu')
    closs, _, cw, cb = linear_recipe(cpu, path)
    for k, (a, c) in enumerate(zip(losses, closs)):
        check(abs(a - c) <= SPARSE_RTOL * abs(c),
              'epoch %d loss %.7f, on the CPU %.7f' % (k, a, c))
    werr = _held(w.handle, cw.handle, SPARSE_RTOL, 'the trained w')
    _held(b.handle, cb.handle, SPARSE_RTOL, 'the trained b')
    log('    held against the CPU: losses within %.0e, w max err %.3e'
        % (SPARSE_RTOL, werr))

    # the dot alone: work proportional to the stored values against the
    # dense lowering of the batch (1.02 GB at 256 x 1,000,000 f32)
    with _ctx_of(device):
        batch = next(iter(_svm_iter(mt, path)))
    csr = batch.data[0]
    nnz = csr.data.shape[0]
    col = mt.nd.array(np.random.RandomState(6).randn(SVM_BATCH, 1).astype(
        np.float32), ctx=_ctx_of(device))
    sparse_ms = device_ms(lambda: mt.nd.sparse.dot(csr, w), runs=20)
    dense_ms = device_ms(lambda: mt.nd.dot(csr.tostype('default'), w),
                         runs=5)
    t_sparse = _wall_ms(lambda: mt.nd.sparse.dot(csr, col, transpose_a=True),
                        device)
    t_dense = _wall_ms(lambda: mt.nd.dot(csr.tostype('default'), col,
                                         transpose_a=True), device)
    bound = (nnz * 4 * 3 + (SVM_BATCH + 1) * 4 + SVM_BATCH * 4) / \
        HBM_BYTES_PER_S * 1e3
    log('    nd.sparse.dot(csr %d x %d, %d nnz; w %d x 1): %.4f ms (CUDA '
        'events) against the dense lowering (cast + dot) %.4f ms; bound '
        '%.2e ms (bytes); csr.T . x: %.4f ms (host wall: the unique columns '
        'are read back) against %.4f dense'
        % (SVM_BATCH, SVM_FEATURES, nnz, SVM_FEATURES, sparse_ms, dense_ms,
           bound, t_sparse, t_dense))

    outs, mms, params = sparse_module(device, path, SVM_MODULE_BATCHES)
    couts, _, cparams = sparse_module(cpu, path, SVM_MODULE_CPU)
    for k in range(SVM_MODULE_CPU):
        _held(outs[k], couts[k], SPARSE_RTOL, 'Module output, batch %d' % k)
    log('    the reference script\'s Module form (row_sparse_pull, the CSR '
        'batch densified on the card, 1.02 GB): %s ms a batch; outputs of '
        'batches 1-%d held against the CPU'
        % (', '.join('%.2f' % m for m in mms), SVM_MODULE_CPU))
    check(all(np.isfinite(v.numpy()).all() for v in params.values()),
          'the Module\'s parameters are not finite')
    return path, csr


def storage_round_trips(device, path, work):
    """Phase (t2): cast_storage both ways, retain, square_sum, add and
    nd.save/nd.load on the card, each against the CPU."""
    import torch
    import mxnet_tpu_torch as mt
    cpu = torch.device('cpu')
    whole = SVM_BATCH * SVM_BATCHES
    sides = {}
    for dev in (device, cpu):
        with _ctx_of(dev):
            sides[dev.type] = next(iter(_svm_iter(mt, path, whole))).data[0]
    card, host = sides[device.type], sides['cpu']
    # csr [8192, 1,000,000] -> dense (32.8 GB f32) -> csr
    t0 = time.perf_counter()
    dense = mt.nd.cast_storage(card, 'default')
    back = dense.tostype('csr')
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    # the CPU's csr of the same dense array: the file's explicit zeros
    # ('0.0000' values) dropped, as a cast from dense drops them
    import scipy.sparse as sp
    m = sp.csr_matrix((host.data.asnumpy(), host.indices.asnumpy(),
                       host.indptr.asnumpy()), shape=host.shape)
    m.eliminate_zeros()
    for part, want in (('data', m.data), ('indptr', m.indptr),
                       ('indices', m.indices)):
        _exact(getattr(back, part).handle,
               torch.from_numpy(want.astype(np.float32 if part == 'data'
                                            else np.int32)),
               'csr -> dense -> csr ' + part)
    del dense, back
    log('    csr [%d, %d] (%d stored, %d of them zeros) -> dense -> csr: '
        'bit for bit the CPU\'s csr of the same array, %.1f ms (host wall)'
        % (whole, SVM_FEATURES, host.data.shape[0],
           host.data.shape[0] - m.nnz, ms))
    # row_sparse [1,000,000, 128]: the sparse head's gradient shape, rows
    # the first batch's features
    ids = np.unique(host.indices.asnumpy()[:int(host.indptr.asnumpy()[
        SVM_BATCH])])
    ids2 = np.unique(host.indices.asnumpy()[int(host.indptr.asnumpy()[
        SVM_BATCH]):int(host.indptr.asnumpy()[2 * SVM_BATCH])])
    rng = np.random.RandomState(7)
    vals = rng.randn(len(ids), SPARSE_CLASSES).astype(np.float32)
    vals2 = rng.randn(len(ids2), SPARSE_CLASSES).astype(np.float32)
    res = {}
    for dev in (device, cpu):
        with _ctx_of(dev):
            shape = (SVM_FEATURES, SPARSE_CLASSES)
            r = mt.nd.sparse.row_sparse_array((vals, ids), shape=shape)
            r2 = mt.nd.sparse.row_sparse_array((vals2, ids2), shape=shape)
            d = r.tostype('default')
            rr = mt.nd.cast_storage(d, 'row_sparse')
            col = mt.nd.sparse.row_sparse_array(
                (vals[:, :1], ids), shape=(SVM_FEATURES, 1))
            res[dev.type] = {
                'dense': d.handle, 'rsp.data': rr.data.handle,
                'rsp.indices': rr.indices.handle,
                'retain.data': r.retain(mt.nd.array(ids2)).data.handle,
                'retain.indices': r.retain(mt.nd.array(ids2)).indices.handle,
                'add.data': (r + r2).data.handle,
                'add.indices': (r + r2).indices.handle,
                'square_sum axis 1 [1M, 1]':
                    mt.nd.sparse.square_sum(col, axis=1).handle,
                'square_sum': mt.nd.sparse.square_sum(r).handle,
                'square_sum axis 0': mt.nd.sparse.square_sum(r, axis=0).handle,
                'square_sum axis 1': mt.nd.sparse.square_sum(
                    r, axis=1, keepdims=True).data.handle}
            f = os.path.join(work, 'sparse-%s.params' % dev.type)
            mt.nd.save(f, {'csr': sides[dev.type], 'rsp': r}, fmt='mxnet')
            loaded = mt.nd.load(f)
            for part in ('data', 'indptr', 'indices'):
                _exact(getattr(loaded['csr'], part).handle,
                       getattr(host, part).handle, 'loaded csr ' + part)
            _exact(loaded['rsp'].data.handle, torch.from_numpy(vals),
                   'loaded row_sparse data')
    for k in res['cpu']:
        if k.startswith('square_sum') and not k.endswith('[1M, 1]'):
            _held(res[device.type][k], res['cpu'][k], SQUARE_SUM_RTOL, k)
        else:
            _exact(res[device.type][k], res['cpu'][k], k)
    files = [open(os.path.join(work, 'sparse-%s.params' % t), 'rb').read()
             for t in (device.type, 'cpu')]
    check(files[0] == files[1], 'the card\'s sparse file differs from the '
          'CPU\'s')
    log('    row_sparse [%d, %d] (%d rows) -> dense -> row_sparse, retain, '
        'add: bit for bit the CPU\'s; square_sum along 1 of [1M, 1] bit for '
        'bit, its sums along each axis within %.0e; nd.save of csr and '
        'row_sparse byte for byte the CPU\'s (%d bytes), nd.load bit for bit'
        % (SVM_FEATURES, SPARSE_CLASSES, len(ids), SQUARE_SUM_RTOL,
           len(files[0])))


def sparse_head(device, path):
    """Phase (t3): a multi-class head over (t1)'s CSR batches, W [1M,
    classes] f32, the class of a row its first feature modulo classes:
    nd.sparse.dot -> nd.softmax_cross_entropy (K3) and nd.softmax (K5) ->
    the transposed sparse dot -> the dense update, two passes (the loss
    falls on the second). Every launch counted over both. Returns
    ({wrapper: launches}, ms a batch)."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    ctx = _ctx_of(device)
    classes = SPARSE_CLASSES
    g = torch.Generator(device=device).manual_seed(8)
    with ctx:
        W = mt.nd.from_torch(0.01 * torch.randn(
            (SVM_FEATURES, classes), generator=g, device=device))
        W0 = W.handle.detach().cpu()
        it = _svm_iter(mt, path)
        batches = list(it)
    counters = _staged_counters()
    _zero_counts(counters)
    losses, ms, first = [], [], None
    with ctx:
        for batch in batches * SVM_EPOCHS:
            t0 = time.perf_counter()
            csr = batch.data[0]
            ptr = csr.indptr.handle.long()
            label = mt.nd.from_torch(
                (csr.indices.handle[ptr[:-1]] % classes).float())
            logits = mt.nd.sparse.dot(csr, W)
            loss = mt.nd.softmax_cross_entropy(logits, label)
            prob = mt.nd.softmax(logits)
            onehot = mt.nd.one_hot(label, classes)
            gW = mt.nd.sparse.dot(csr, (prob - onehot) / csr.shape[0],
                                  transpose_a=True)
            W = W - (SPARSE_LR * gW).tostype('default')
            losses.append(float(loss.asscalar()) / csr.shape[0])
            ms.append((time.perf_counter() - t0) * 1e3)
            if first is None:
                first = (logits.handle, label.handle, loss.handle,
                         prob.handle)
    launches = _counts(counters)
    n = len(batches) * SVM_EPOCHS
    # off the card the wrappers run their plain versions: no launch
    want = n if device.type == 'cuda' else 0
    check(launches['softmax_xent_fwd'] == want and
          launches['softmax_fwd'] == want,
          'the sparse head launched K3 %d and K5 %d times over %d batches'
          % (launches['softmax_xent_fwd'], launches['softmax_fwd'], n))
    logits, label, loss, prob = first
    # against the plain versions on the same logits, and the CPU's head
    xerr = _held(loss, ck.softmax_xent_ref(logits, label.long()).sum(),
                 1e-5, 'K3 against xent_ref')
    perr = _held(prob, ck.softmax_ref(logits), 1e-5, 'K5 against softmax_ref')
    with mt.cpu():
        cbatch = next(iter(_svm_iter(mt, path)))
        clog = mt.nd.sparse.dot(cbatch.data[0], mt.nd.from_torch(W0))
    lerr = _held(logits, clog.handle, SPARSE_RTOL, 'the head\'s logits')
    _held(loss, mt.nd.softmax_cross_entropy(
        clog, mt.nd.from_torch(label.cpu())).handle, SPARSE_RTOL,
          'the head\'s loss')
    per = len(batches)
    epochs = [float(np.mean(losses[k:k + per])) for k in range(0, n, per)]
    check(epochs[-1] < epochs[0], 'the head\'s loss did not fall: %s'
          % epochs)
    log('    %d passes over %d batches: K3 %d and K5 %d launches; mean loss '
        '%s a pass; %.3f ms a batch (median, synchronised host wall); K3 '
        'against xent_ref %.2e, K5 against softmax_ref %.2e, logits against '
        'the CPU %.2e'
        % (SVM_EPOCHS, per, launches['softmax_xent_fwd'],
           launches['softmax_fwd'], ', '.join('%.4f' % e for e in epochs),
           statistics.median(ms), xerr, perr, lerr))
    return launches, statistics.median(ms)


def ssd300_anchors(mt):
    """SSD300's 8,732 anchors [1, 8732, 4] from its six maps."""
    parts = []
    for side, sizes, ratios, step in zip(SSD300_MAPS, SSD300_SIZES,
                                         SSD300_RATIOS, SSD300_STEPS):
        parts.append(mt.nd.contrib.MultiBoxPrior(
            mt.nd.zeros((1, 1, side, side)), sizes=sizes, ratios=ratios,
            clip=False, steps=(step / 300.0, step / 300.0)))
    return mt.nd.concatenate(parts, axis=1)


def ssd300_ops(device):
    """Phase (t4)'s second half: MultiBoxPrior, MultiBoxTarget,
    MultiBoxDetection and box_iou at SSD300's widths, each against the
    CPU. Returns {op: ms}."""
    import torch
    import mxnet_tpu_torch as mt
    rng = np.random.RandomState(9)
    label = -np.ones((SSD_BATCH, SSD_MAX_OBJECTS, 5), np.float32)
    for i in range(SSD_BATCH):
        for j in range(rng.randint(1, SSD_MAX_OBJECTS + 1)):
            x0, y0 = rng.uniform(0, 0.8, 2)
            w, h = rng.uniform(0.03, 0.5, 2)
            label[i, j] = [rng.randint(SSD_CLASSES - 1), x0, y0,
                           min(x0 + w, 1.0), min(y0 + h, 1.0)]
    logits = rng.randn(SSD_BATCH, SSD_CLASSES, 8732).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (0.5 * rng.randn(SSD_BATCH, 8732 * 4)).astype(np.float32)
    out = {}
    for side, dev in (('card', device), ('cpu', torch.device('cpu'))):
        with _ctx_of(dev):
            anchor = ssd300_anchors(mt)
            check(anchor.shape == (1, 8732, 4), 'SSD300 has %s anchors'
                  % (anchor.shape,))
            lab, pr, lc = (mt.nd.array(a) for a in (label, prob, loc))
            n = SSD_BATCH if side == 'card' else SSD_CPU_SAMPLES
            tgt = mt.nd.contrib.MultiBoxTarget(anchor, lab, pr)
            det = mt.nd.contrib.MultiBoxDetection(pr[:n], lc[:n], anchor)
            rows = 8732 if side == 'card' else SSD_IOU_CPU_ROWS
            iou = mt.nd.contrib.box_iou(anchor.reshape((-1, 4))[:rows],
                                        anchor.reshape((-1, 4)))
            out[side] = [anchor, tgt, det, iou, (anchor, lab, pr, lc)]
    card, cpu = out['card'], out['cpu']
    _held(card[0].handle, cpu[0].handle, CONTRIB_RTOL, 'MultiBoxPrior')
    names = ('loc_target', 'loc_mask', 'cls_target')
    for nm, a, b in zip(names, card[1], cpu[1]):
        if nm == 'loc_target':
            _held(a.handle, b.handle, CONTRIB_RTOL, 'MultiBoxTarget ' + nm)
        else:
            _exact(a.handle, b.handle, 'MultiBoxTarget ' + nm)
    d, c = card[2].handle[:SSD_CPU_SAMPLES], cpu[2].handle
    _exact(d[..., 0], c[..., 0], 'MultiBoxDetection class ids')
    _held(d[..., 1:], c[..., 1:], CONTRIB_RTOL,
          'MultiBoxDetection scores and boxes')
    _held(card[3].handle[:SSD_IOU_CPU_ROWS], cpu[3].handle, CONTRIB_RTOL,
          'box_iou')
    kept = int((card[2].handle[..., 0] >= 0).sum())
    matched = int((card[1][2].handle > 0).sum())
    anchor, lab, pr, lc = card[4]
    with _ctx_of(device):
        ms = {'MultiBoxPrior': device_ms(lambda: ssd300_anchors(mt), runs=10)}
    ms.update({
        'MultiBoxTarget': device_ms(lambda: mt.nd.contrib.MultiBoxTarget(
            anchor, lab, pr), runs=10),
        'MultiBoxDetection': device_ms(
            lambda: mt.nd.contrib.MultiBoxDetection(pr, lc, anchor), runs=5),
        'box_iou': device_ms(lambda: mt.nd.contrib.box_iou(
            anchor.reshape((-1, 4)), anchor.reshape((-1, 4))), runs=10)})
    log('    SSD300 (8,732 anchors, %d classes, batch %d, 1-%d objects): '
        '%d anchors matched, %d detections kept; class ids and targets '
        'exact, boxes and scores within %.0e of the CPU (detection: the '
        'first %d samples; box_iou: the first %d rows); ms (CUDA events): %s'
        % (SSD_CLASSES, SSD_BATCH, SSD_MAX_OBJECTS, matched, kept,
           CONTRIB_RTOL, SSD_CPU_SAMPLES, SSD_IOU_CPU_ROWS,
           ', '.join('%s %.3f' % kv for kv in ms.items())))
    return ms


def ssd_symbol(mt, mode='train'):
    """examples/ssd/train_ssd.py's network."""
    def conv_block(data, num_filter, name, stride=(1, 1)):
        c = mt.sym.Convolution(data=data, num_filter=num_filter,
                               kernel=(3, 3), stride=stride, pad=(1, 1),
                               name=name + '_conv')
        b = mt.sym.BatchNorm(data=c, name=name + '_bn')
        return mt.sym.Activation(data=b, act_type='relu', name=name + '_relu')

    data = mt.sym.Variable('data')
    label = mt.sym.Variable('label')
    body = conv_block(data, 16, 'b1')
    body = mt.sym.Pooling(data=body, kernel=(2, 2), stride=(2, 2),
                          pool_type='max')
    body = conv_block(body, 32, 'b2')
    scale1 = mt.sym.Pooling(data=body, kernel=(2, 2), stride=(2, 2),
                            pool_type='max')
    scale1 = conv_block(scale1, 64, 'b3')
    scale2 = conv_block(scale1, 64, 'b4', stride=(2, 2))
    preds, anchors = [], []
    cfg = [(scale1, (0.2, 0.35), (1.0, 2.0, 0.5)),
           (scale2, (0.4, 0.6), (1.0, 2.0, 0.5))]
    per = len(cfg[0][2]) + len(cfg[0][1]) - 1
    for i, (feat, sizes, ratios) in enumerate(cfg):
        anc = mt.sym.contrib.MultiBoxPrior(feat, sizes=sizes, ratios=ratios,
                                           clip=True, name='anchors%d' % i)
        pred = mt.sym.Convolution(data=feat, num_filter=per * (SSD_FG + 5),
                                  kernel=(3, 3), pad=(1, 1),
                                  name='pred%d' % i)
        pred = mt.sym.transpose(pred, axes=(0, 2, 3, 1))
        preds.append(mt.sym.Reshape(pred, shape=(0, -1, SSD_FG + 5)))
        anchors.append(mt.sym.Reshape(anc, shape=(0, -1, 4)))
    pred = mt.sym.Concat(*preds, dim=1)
    anchor = mt.sym.Concat(*anchors, dim=1)
    cls_pred = mt.sym.slice_axis(pred, axis=2, begin=0, end=SSD_FG + 1)
    loc_pred = mt.sym.Reshape(mt.sym.slice_axis(
        pred, axis=2, begin=SSD_FG + 1, end=SSD_FG + 5), shape=(0, -1))
    cls_pred_t = mt.sym.transpose(cls_pred, axes=(0, 2, 1))
    if mode == 'train':
        loc_t, loc_m, cls_t = mt.sym.contrib.MultiBoxTarget(
            anchor, label, cls_pred_t, overlap_threshold=0.5,
            name='multibox_target')
        cls_loss = mt.sym.SoftmaxOutput(data=cls_pred_t, label=cls_t,
                                        multi_output=True, use_ignore=True,
                                        ignore_label=-1,
                                        normalization='valid',
                                        name='cls_prob')
        loc_loss = mt.sym.MakeLoss(mt.sym.smooth_l1(
            loc_m * (loc_pred - loc_t), scalar=1.0), grad_scale=1.0,
            name='loc_loss')
        return mt.sym.Group([cls_loss, loc_loss,
                             mt.sym.BlockGrad(cls_t, name='cls_label')])
    cls_prob = mt.sym.softmax(cls_pred_t, axis=1)
    det = mt.sym.contrib.MultiBoxDetection(cls_prob, loc_pred, anchor,
                                           nms_threshold=0.5,
                                           name='detection')
    return mt.sym.Group([det, cls_prob, loc_pred, anchor])


def ssd_data(n, seed=0):
    """train_ssd.py's synthetic boxes: images [n, 3, 64, 64], labels [n, 4,
    5] of (class, box) normalised, -1 padding."""
    rng = np.random.RandomState(seed)
    images = np.zeros((n, 3, SSD_IMG, SSD_IMG), np.float32)
    labels = -np.ones((n, SSD_OBJS, 5), np.float32)
    for i in range(n):
        for j in range(rng.randint(1, SSD_OBJS + 1)):
            cls = rng.randint(0, SSD_FG)
            w, h = rng.uniform(0.2, 0.5, 2)
            x0 = rng.uniform(0, 1 - w)
            y0 = rng.uniform(0, 1 - h)
            xi0, yi0 = int(x0 * SSD_IMG), int(y0 * SSD_IMG)
            xi1, yi1 = int((x0 + w) * SSD_IMG), int((y0 + h) * SSD_IMG)
            images[i, cls, yi0:yi1, xi0:xi1] = 1.0
            labels[i, j] = (cls, x0, y0, x0 + w, y0 + h)
        images[i] += 0.1 * rng.randn(3, SSD_IMG, SSD_IMG)
    return images, labels


def ssd_record(path, n, seed=0):
    """train_ssd.py's vendor_record_dataset: the labelled set packed into a
    detection .rec ([2, 5, objects...] labels, uint8 CHW .raw images)."""
    import mxnet_tpu_torch as mt
    images, labels = ssd_data(n, seed)
    rec = mt.recordio.MXRecordIO(path, 'w')
    for i in range(n):
        objs = labels[i][labels[i][:, 0] >= 0]
        packed = np.concatenate([[2.0, 5.0], objs.ravel()]).astype(np.float32)
        img = (np.clip(images[i], 0.0, 1.0) * 255.0).round().astype(np.uint8)
        rec.write(mt.recordio.pack_img(
            mt.recordio.IRHeader(len(packed), packed, i, 0), img,
            img_fmt='.raw'))
    rec.close()


def ssd_fit(device, work):
    """Phase (t4)'s first half: train_ssd.py's recipe through Module.fit
    from its .rec, then its MultiBoxDetection decode held against the
    CPU's op on the card's own inputs."""
    import torch
    import mxnet_tpu_torch as mt
    ctx = _ctx_of(device)
    rec = os.path.join(work, 'ssd_synth.rec')
    ssd_record(rec, SSD_SAMPLES)

    class DetLabels(mt.io.DataIter):
        """train_ssd.py's adapter: the packed label's header stripped, the
        objects as (B, objects, 5)."""

        def __init__(self, inner):
            super().__init__(inner.batch_size)
            self._it = inner
            self._w = inner.label_object_width

        @property
        def provide_data(self):
            return self._it.provide_data

        @property
        def provide_label(self):
            d = self._it.provide_label[0]
            n_obj = (d.shape[1] - 2) // self._w
            return [mt.io.DataDesc('label', (d.shape[0], n_obj, self._w),
                                   d.dtype)]

        def reset(self):
            self._it.reset()

        def next(self):
            batch = self._it.next()
            lab = batch.label[0].asnumpy()[:, 2:]
            lab = lab.reshape(lab.shape[0], -1, self._w)
            return mt.io.DataBatch([batch.data[0]], [mt.nd.array(
                lab, ctx=mt.cpu())], pad=batch.pad)

    mt.random.seed(0)
    train = DetLabels(mt.io.ImageDetRecordIter(
        path_imgrec=rec, data_shape=(3, SSD_IMG, SSD_IMG),
        batch_size=SSD_EX_BATCH, shuffle=True, scale=1.0 / 255.0,
        label_pad_width=2 + SSD_OBJS * 5))
    mod = mt.mod.Module(ssd_symbol(mt), label_names=('label',), context=ctx)
    mod.bind(data_shapes=train.provide_data, label_shapes=train.provide_label)
    mod.init_params(initializer=mt.init.Xavier())

    class ClsLoss(mt.metric.EvalMetric):
        """The mean -log p of each anchor's target class (ignored anchors
        left out), from the outputs (cls_prob, loc_loss, cls_label)."""

        def update(self, labels, preds):
            import torch
            prob, lab = preds[0].handle, preds[2].handle
            valid = lab >= 0
            p = prob.gather(1, lab.clamp(min=0).long()[:, None])[:, 0]
            self.sum_metric += float(-(torch.log(p + 1e-12) * valid).sum())
            self.num_inst += int(valid.sum())

    def losses():
        # over the training set, by Module.score: the class loss and the
        # example's own metric, the loc loss
        metric = mt.metric.CompositeEvalMetric([
            ClsLoss('cls-loss'),
            mt.metric.Loss(output_names=['loc_loss_output'])])
        value = [v for _, v in mod.score(train, metric)]
        train.reset()
        return value
    before = losses()
    t0 = time.perf_counter()
    mod.fit(train, eval_metric=mt.metric.Loss(output_names=[
        'loc_loss_output']), optimizer='sgd', optimizer_params={
        'learning_rate': SSD_EX_LR, 'momentum': 0.9, 'wd': 5e-4},
        num_epoch=SSD_EPOCHS)
    _sync(device)
    sec = time.perf_counter() - t0
    after = losses()
    batches = SSD_EPOCHS * SSD_SAMPLES // SSD_EX_BATCH
    check(np.isfinite(before + after).all() and after[0] < before[0],
          'the SSD class loss did not fall: %s -> %s' % (before, after))
    log('    train_ssd.py through Module.fit (%d images of %d x %d, batch %d, '
        '%d epochs, from the .rec): over the set (Module.score) the class '
        'loss %.5f -> %.5f, the loc loss %.5f -> %.5f; %.1f ms a batch '
        '(host wall over the fit)'
        % (SSD_SAMPLES, SSD_IMG, SSD_IMG, SSD_EX_BATCH, SSD_EPOCHS,
           before[0], after[0], before[1], after[1], sec * 1e3 / batches))
    images, labels = ssd_data(64, 0)
    det = mt.mod.Module(ssd_symbol(mt, 'test'), data_names=('data',),
                        label_names=None, context=ctx)
    det.bind(data_shapes=[('data', images.shape)], for_training=False)
    args, auxs = mod.get_params()
    det.set_params(args, auxs, allow_missing=False)
    det.forward(mt.io.DataBatch([mt.nd.array(images, ctx=ctx)], []),
                is_train=False)
    out, prob, loc, anchor = (o.handle for o in det.get_outputs())
    with mt.cpu():
        want = mt.nd.contrib.MultiBoxDetection(
            *(mt.nd.from_torch(t.detach().cpu()) for t in (prob, loc, anchor)),
            nms_threshold=0.5).handle
    _exact(out[..., 0], want[..., 0], 'the decode\'s class ids')
    _held(out[..., 1:], want[..., 1:], CONTRIB_RTOL,
          'the decode\'s scores and boxes')
    # the example's recall: ground truth matched by a same-class detection
    # of IoU over 0.5 and score over 0.2
    o = out.detach().cpu().numpy()
    matched = total = 0
    for i in range(len(images)):
        dets = o[i][(o[i, :, 0] >= 0) & (o[i, :, 1] > 0.2)]
        for obj in labels[i][labels[i][:, 0] >= 0]:
            total += 1
            for d in dets:
                if int(d[0]) != int(obj[0]):
                    continue
                ix0, iy0 = np.maximum(d[2:4], obj[1:3])
                ix1, iy1 = np.minimum(d[4:6], obj[3:5])
                inter = max(0, ix1 - ix0) * max(0, iy1 - iy0)
                ua = ((d[4] - d[2]) * (d[5] - d[3]) +
                      (obj[3] - obj[1]) * (obj[4] - obj[2]) - inter)
                if ua > 0 and inter / ua > 0.5:
                    matched += 1
                    break
    log('    its MultiBoxDetection decode of 64 images: class ids exact and '
        'scores and boxes within %.0e of the CPU\'s op on the same inputs; '
        'recall %.3f' % (CONTRIB_RTOL, matched / max(total, 1)))


# -- Faster R-CNN -------------------------------------------------------------

def rcnn_anchors():
    """train_rcnn_lite.py's anchor grid ((y, x, A) order)."""
    feat = RCNN_IMG // RCNN_STRIDE
    base = RCNN_STRIDE / 2.0
    anchors = []
    for y in range(feat):
        for x in range(feat):
            cx, cy = x * RCNN_STRIDE + base, y * RCNN_STRIDE + base
            for r in RPN_RATIOS:
                for s in RCNN_SCALES:
                    size = s * RCNN_STRIDE
                    w = size * np.sqrt(1.0 / r)
                    h = size * np.sqrt(r)
                    anchors.append([cx - w / 2, cy - h / 2, cx + w / 2,
                                    cy + h / 2])
    return np.asarray(anchors, np.float32)


def _iou_np(a, b):
    ix0 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy0 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix1 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy1 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter,
                              1e-6)


def rcnn_scenes(rng, n, anchors):
    """train_rcnn_lite.py's scene_batch: images, RPN labels, bbox targets
    and masks in the conv layout, and the scenes."""
    A = len(RCNN_SCALES) * len(RPN_RATIOS)
    feat = RCNN_IMG // RCNN_STRIDE
    imgs = np.zeros((n, 3, RCNN_IMG, RCNN_IMG), np.float32)
    labels = np.zeros((n, len(anchors)), np.float32)
    btgts = np.zeros((n, len(anchors), 4), np.float32)
    scenes = []
    for i in range(n):
        img = rng.randn(3, RCNN_IMG, RCNN_IMG).astype(np.float32) * 0.1
        boxes, classes = [], []
        for _ in range(rng.randint(1, 3)):
            cls = rng.randint(RCNN_FG)
            w, h = rng.uniform(12, 28, 2)
            x0 = rng.uniform(2, RCNN_IMG - w - 2)
            y0 = rng.uniform(2, RCNN_IMG - h - 2)
            img[cls][int(y0):int(y0 + h), int(x0):int(x0 + w)] += 1.0
            boxes.append([x0, y0, x0 + w, y0 + h])
            classes.append(cls)
        boxes = np.asarray(boxes, np.float32)
        imgs[i] = img
        iou = _iou_np(anchors, boxes)
        lab = -np.ones(len(anchors), np.float32)
        lab[iou.max(1) < 0.2] = 0
        lab[iou.max(1) > 0.5] = 1
        lab[iou.argmax(0)] = 1
        tgt = np.zeros((len(anchors), 4), np.float32)
        pos = np.where(lab == 1)[0]
        g = boxes[iou[pos].argmax(1)]
        aw = anchors[pos, 2] - anchors[pos, 0]
        ah = anchors[pos, 3] - anchors[pos, 1]
        gw = g[:, 2] - g[:, 0]
        gh = g[:, 3] - g[:, 1]
        tgt[pos, 0] = (g[:, 0] + gw / 2 - anchors[pos, 0] - aw / 2) / aw
        tgt[pos, 1] = (g[:, 1] + gh / 2 - anchors[pos, 1] - ah / 2) / ah
        tgt[pos, 2] = np.log(gw / aw)
        tgt[pos, 3] = np.log(gh / ah)
        labels[i], btgts[i] = lab, tgt
        scenes.append((boxes, np.asarray(classes)))
    perm = np.arange(len(anchors)).reshape(feat, feat, A).transpose(
        2, 0, 1).ravel()
    labels = labels[:, perm]
    btgts = btgts[:, perm].reshape(n, A, feat, feat, 4).transpose(
        0, 1, 4, 2, 3).reshape(n, A * 4, feat, feat)
    masks = (labels.reshape(n, A, feat, feat) == 1)[:, :, None]
    masks = np.repeat(masks, 4, axis=2).reshape(n, A * 4, feat, feat)
    return imgs, labels, btgts, masks.astype(np.float32), scenes


def rpn_symbol(mt):
    A = len(RCNN_SCALES) * len(RPN_RATIOS)
    feat = RCNN_IMG // RCNN_STRIDE
    x = mt.sym.Variable('data')
    lab = mt.sym.Variable('rpn_label')
    btgt = mt.sym.Variable('rpn_bbox_target')
    bmask = mt.sym.Variable('rpn_bbox_mask')
    for i, nf in enumerate([16, 32, 32]):
        x = mt.sym.Convolution(x, kernel=(3, 3), num_filter=nf, stride=(2, 2),
                               pad=(1, 1), name='b%d' % i)
        x = mt.sym.Activation(x, act_type='relu')
    f = mt.sym.Activation(mt.sym.Convolution(
        x, kernel=(3, 3), pad=(1, 1), num_filter=32, name='rpn_conv'),
        act_type='relu')
    cls = mt.sym.Convolution(f, kernel=(1, 1), num_filter=2 * A,
                             name='rpn_cls')
    bbox = mt.sym.Convolution(f, kernel=(1, 1), num_filter=4 * A,
                              name='rpn_bbox')
    cls_loss = mt.sym.SoftmaxOutput(
        mt.sym.Reshape(cls, shape=(0, 2, -1)), lab, multi_output=True,
        use_ignore=True, ignore_label=-1, normalization='valid',
        name='rpn_cls_prob')
    bb_loss = mt.sym.MakeLoss(mt.sym.smooth_l1(bmask * (bbox - btgt),
                                               scalar=3.0),
                              grad_scale=1.0 / (feat * feat),
                              name='rpn_bbox_loss')
    return mt.sym.Group([cls_loss, bb_loss, mt.sym.BlockGrad(cls),
                         mt.sym.BlockGrad(bbox)])


def rcnn_fit(device):
    """Phase (t5)'s first half: train_rcnn_lite.py's two stages on the
    card, the proposals and the pooled rois held against the CPU's ops on
    the card's own inputs, and the example's own gates (RPN recall over
    0.5, head accuracy over 0.7)."""
    import mxnet_tpu_torch as mt
    ctx = _ctx_of(device)
    A = len(RCNN_SCALES) * len(RPN_RATIOS)
    feat = RCNN_IMG // RCNN_STRIDE
    mt.random.seed(0)
    rng = np.random.RandomState(0)
    anchors = rcnn_anchors()
    imgs, labels, btgts, masks, scenes = rcnn_scenes(rng, RCNN_SAMPLES,
                                                     anchors)
    t0 = time.perf_counter()
    with ctx:
        it = mt.io.NDArrayIter({'data': imgs}, {
            'rpn_label': labels, 'rpn_bbox_target': btgts,
            'rpn_bbox_mask': masks}, batch_size=RCNN_BATCH, shuffle=True)
        mod = mt.mod.Module(rpn_symbol(mt), data_names=('data',),
                            label_names=('rpn_label', 'rpn_bbox_target',
                                         'rpn_bbox_mask'), context=ctx)
        mod.fit(it, num_epoch=RCNN_RPN_EPOCHS, optimizer='adam',
                optimizer_params={'learning_rate': RCNN_LR},
                initializer=mt.init.Xavier(),
                eval_metric=mt.metric.Loss(
                    output_names=['rpn_bbox_loss_output']))
        arg_p, aux_p = mod.get_params()
        internals = rpn_symbol(mt).get_internals()
        cls_sm = mt.sym.Reshape(mt.sym.softmax(mt.sym.Reshape(
            internals['rpn_cls_output'], shape=(0, 2, -1)), axis=1),
            shape=(0, 2 * A, feat, feat))
        attrs = dict(rpn_pre_nms_top_n=64, rpn_post_nms_top_n=16,
                     threshold=0.7, rpn_min_size=4, scales=RCNN_SCALES,
                     ratios=RPN_RATIOS, feature_stride=RCNN_STRIDE)
        rois_sym = mt.sym.contrib.MultiProposal(
            cls_sm, internals['rpn_bbox_output'], mt.sym.Variable('im_info'),
            name='proposals', **attrs)
        prop = mt.mod.Module(mt.sym.Group([rois_sym, internals['b2_output'],
                                           cls_sm,
                                           internals['rpn_bbox_output']]),
                             data_names=('data', 'im_info'), label_names=None,
                             context=ctx)
        prop.bind(data_shapes=[('data', (RCNN_BATCH, 3, RCNN_IMG, RCNN_IMG)),
                               ('im_info', (RCNN_BATCH, 3))],
                  for_training=False)
        prop.set_params(arg_p, aux_p, allow_missing=True)
        info = np.tile([RCNN_IMG, RCNN_IMG, 1.0], (RCNN_BATCH, 1)).astype(
            np.float32)

        def proposals(batch_imgs):
            prop.forward(mt.io.DataBatch([mt.nd.array(batch_imgs),
                                          mt.nd.array(info)], []),
                         is_train=False)
            return prop.get_outputs()

        rois, feats, cls_prob, bbox = proposals(imgs[:RCNN_BATCH])
        with mt.cpu():
            want = mt.nd.contrib.MultiProposal(
                mt.nd.from_torch(cls_prob.handle.cpu()),
                mt.nd.from_torch(bbox.handle.cpu()), mt.nd.array(info),
                **attrs).handle
        _held(rois.handle, want, CONTRIB_RTOL, 'the RPN\'s proposals')
        _exact((rois.handle[:, 1:] == 0).all(1), (want[:, 1:] == 0).all(1),
               'the proposals\' zero tail')
        r = rois.asnumpy()
        covered = total = 0
        for b in range(RCNN_BATCH):
            mine = r[r[:, 0] == b][:, 1:]
            total += len(scenes[b][0])
            if len(mine):
                covered += (_iou_np(scenes[b][0], mine).max(1) > 0.5).sum()
        recall = covered / max(1, total)
        check(recall > 0.5, 'RPN proposal recall %.2f (the example needs '
              'over 0.5)' % recall)
        pooled_all, roi_labels = [], []
        for s in range(0, RCNN_SAMPLES, RCNN_BATCH):
            rois, feats = (o.asnumpy() for o in proposals(
                imgs[s:s + RCNN_BATCH])[:2])
            keep_rois, labs = [], []
            for b in range(RCNN_BATCH):
                gt_boxes, gt_cls = scenes[s + b]
                mine = rois[rois[:, 0] == b]
                if not len(mine):
                    continue
                iou = _iou_np(mine[:, 1:], gt_boxes)
                lab = np.where(iou.max(1) > 0.5, gt_cls[iou.argmax(1)] + 1, 0)
                keep = np.concatenate([np.where(lab > 0)[0],
                                       np.where(lab == 0)[0][:4]])
                keep_rois.append(mine[keep])
                labs.append(lab[keep])
            if not keep_rois:
                continue
            keep_rois = np.concatenate(keep_rois)
            pooled = mt.nd.ROIPooling(mt.nd.array(feats),
                                      mt.nd.array(keep_rois),
                                      pooled_size=(4, 4),
                                      spatial_scale=1.0 / RCNN_STRIDE)
            if s == 0:
                with mt.cpu():
                    want = mt.nd.ROIPooling(
                        mt.nd.array(feats), mt.nd.array(keep_rois),
                        pooled_size=(4, 4), spatial_scale=1.0 / RCNN_STRIDE)
                _held(pooled.handle, want.handle, CONTRIB_RTOL,
                      'the example\'s ROIPooling')
            pooled_all.append(pooled.asnumpy())
            roi_labels.append(np.concatenate(labs))
        pooled_all = np.concatenate(pooled_all).astype(np.float32)
        roi_labels = np.concatenate(roi_labels).astype(np.float32)
        h = mt.sym.Activation(mt.sym.FullyConnected(
            mt.sym.flatten(mt.sym.Variable('pooled')), num_hidden=64,
            name='h1'), act_type='relu')
        head = mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
            h, num_hidden=RCNN_FG + 1, name='h2'), name='softmax')
        hmod = mt.mod.Module(head, data_names=('pooled',),
                             label_names=('softmax_label',), context=ctx)
        hit = mt.io.NDArrayIter({'pooled': pooled_all},
                                {'softmax_label': roi_labels}, batch_size=32,
                                shuffle=True)
        hmod.fit(hit, num_epoch=RCNN_HEAD_EPOCHS, optimizer='adam',
                 optimizer_params={'learning_rate': RCNN_LR},
                 initializer=mt.init.Xavier(), eval_metric='acc')
        acc = dict(hmod.score(hit, 'acc'))['accuracy']
    check(acc > 0.7, 'ROI head accuracy %.2f (the example needs over 0.7)'
          % acc)
    log('    train_rcnn_lite.py (%d scenes, RPN %d epochs, head %d epochs on '
        '%d pooled rois): proposals and pooled rois held against the CPU; '
        'RPN recall %.2f, head accuracy %.2f; %.1f s'
        % (RCNN_SAMPLES, RCNN_RPN_EPOCHS, RCNN_HEAD_EPOCHS, len(pooled_all),
           recall, acc, time.perf_counter() - t0))


def rpn_inputs(seed=10):
    """cls_prob [2, 18, 38, 63] (a softmax over each anchor's background
    and foreground maps), bbox_pred [2, 36, 38, 63], im_info of two
    600 x 1000 images."""
    rng = np.random.RandomState(seed)
    A = len(RPN_SCALES) * len(RPN_RATIOS)
    fh, fw = RPN_MAP
    logits = rng.randn(RPN_IMAGES, 2, A, fh, fw).astype(np.float32)
    e = np.exp(logits - logits.max(1, keepdims=True))
    prob = (e / e.sum(1, keepdims=True)).reshape(RPN_IMAGES, 2 * A, fh, fw)
    bbox = (0.1 * rng.randn(RPN_IMAGES, 4 * A, fh, fw)).astype(np.float32)
    info = np.array([[600, 1000, 1.0]] * RPN_IMAGES, np.float32)
    return prob.astype(np.float32), bbox, info


def rpn_and_roi_pooling(device):
    """Phase (t5)'s second half: MultiProposal at the op's reference
    defaults (pre-NMS 6,000, post-NMS 300, threshold 0.7, min size 16,
    stride 16) with the Faster R-CNN paper's 9 anchors; ROIPooling 7 x 7 at
    1/16 over its 600 rois on a [2, 512, 38, 63] map, forward and backward.
    Returns {op: ms}."""
    import torch
    import mxnet_tpu_torch as mt
    prob, bbox, info = rpn_inputs()
    attrs = dict(scales=RPN_SCALES, ratios=RPN_RATIOS, output_score=True)
    res = {}
    for dev in (device, torch.device('cpu')):
        with _ctx_of(dev):
            res[dev.type] = [o.handle for o in mt.nd.contrib.MultiProposal(
                *(mt.nd.array(a) for a in (prob, bbox, info)), **attrs)]
    rois, scores = res[device.type]
    _held(rois, res['cpu'][0], CONTRIB_RTOL, 'MultiProposal rois')
    _held(scores, res['cpu'][1], CONTRIB_RTOL, 'MultiProposal scores')
    _exact(scores == 0, res['cpu'][1] == 0, 'MultiProposal\'s kept slots')
    kept = int((scores != 0).sum())
    ctx = _ctx_of(device)
    p_nd = [mt.nd.array(a, ctx=ctx) for a in (prob, bbox, info)]
    prop_ms = _wall_ms(lambda: mt.nd.contrib.MultiProposal(*p_nd, **attrs),
                       device)

    g = torch.Generator(device='cpu').manual_seed(11)
    data = torch.randn((RPN_IMAGES, ROI_CHANNELS) + RPN_MAP, generator=g)
    cot = torch.randn((rois.shape[0], ROI_CHANNELS, 7, 7), generator=g)
    attrs = {'pooled_size': (7, 7), 'spatial_scale': 1.0 / 16}
    op = mt.ops.registry.get('ROIPooling').fn

    def fwd_bwd(x, r, c):
        x = x.detach().requires_grad_()
        out = op(attrs, x, r)
        grad, = torch.autograd.grad(out, x, c)
        return out.detach(), grad
    d_card, r_card, c_card = (t.to(device) for t in (data, rois, cot))
    out, grad = fwd_bwd(d_card, r_card, c_card)
    want, wgrad = fwd_bwd(data, rois.cpu()[:ROI_CPU], cot[:ROI_CPU])
    _held(out[:ROI_CPU], want, CONTRIB_RTOL, 'ROIPooling (first %d rois)'
          % ROI_CPU)
    _, sub_grad = fwd_bwd(d_card, r_card[:ROI_CPU], c_card[:ROI_CPU])
    _held(sub_grad, wgrad, CONTRIB_GRAD_RTOL, 'ROIPooling\'s gradient (first '
          '%d rois)' % ROI_CPU)
    check(torch.isfinite(grad).all(), 'ROIPooling\'s gradient is not finite')
    x = d_card.detach().requires_grad_()
    ms = {'MultiProposal': prop_ms,
          'ROIPooling': device_ms(lambda: op(attrs, d_card, r_card), runs=5),
          'ROIPooling fwd+bwd': device_ms(lambda: torch.autograd.grad(
              op(attrs, x, r_card), x, c_card), runs=3)}
    log('    MultiProposal (2 x 21,546 anchors, pre-NMS 6,000, post-NMS 300, '
        'threshold 0.7): %d of 600 slots kept, every proposal held against '
        'the CPU; ROIPooling 7 x 7 at 1/16 over those 600 rois on [2, 512, '
        '38, 63]: the first %d rois\' outputs and gradient held against the '
        'CPU; ms: %s (MultiProposal by synchronised host wall: its sweep '
        'reads each block\'s convergence back; ROIPooling by CUDA events)'
        % (kept, ROI_CPU, ', '.join('%s %.3f' % kv for kv in ms.items())))
    return ms


# -- the rest -------------------------------------------------------------------

def _op_vs_cpu(device, name, attrs, inputs, grad_of=(), sub=None, runs=5):
    """Op ``name`` on the card against the port on the CPU: forward, and
    the gradients of inputs ``grad_of`` for a seeded cotangent of the first
    output. ``sub(inputs)`` cuts the inputs that the CPU runs (a few
    samples or rois; the card runs them too for the held gradient).
    Returns (forward ms, forward and backward ms) by CUDA events."""
    import torch
    import mxnet_tpu_torch as mt
    op = mt.ops.registry.get(name)

    def run(ins):
        args = [t.detach().requires_grad_() if i in grad_of else t
                for i, t in enumerate(ins)]
        outs = op.fn(dict(attrs), *args)
        outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        grads = []
        if grad_of:
            cot = torch.from_numpy(np.random.RandomState(12).randn(
                *outs[0].shape).astype(np.float32)).to(outs[0].device)
            grads = torch.autograd.grad(outs[0], [args[i] for i in grad_of],
                                        cot, allow_unused=True)
        return [o.detach() for o in outs], grads
    card_in = [t.to(device) for t in inputs]
    cut = sub(inputs) if sub else inputs
    want, wgrads = run(cut)
    got, ggrads = run([t.to(device) for t in cut])
    for k, (g_, w_) in enumerate(zip(got, want)):
        _held(g_, w_, CONTRIB_RTOL, '%s output %d' % (name, k))
    for i, g_, w_ in zip(grad_of, ggrads, wgrads):
        if w_ is None:
            continue
        _held(g_, w_, CONTRIB_GRAD_RTOL, '%s gradient of input %d'
              % (name, i))
    fwd = device_ms(lambda: op.fn(dict(attrs), *card_in), runs=runs)
    both = None
    if grad_of:
        def fb():
            args = [t.detach().requires_grad_() if i in grad_of else t
                    for i, t in enumerate(card_in)]
            out = op.fn(dict(attrs), *args)
            out = out[0] if isinstance(out, (tuple, list)) else out
            torch.autograd.grad(out, [args[i] for i in grad_of],
                                torch.ones_like(out), allow_unused=True)
        both = device_ms(fb, runs=max(2, runs // 2))
    return fwd, both


def quantize_mlp(device):
    """quantize_mlp.py's recipe on the card: a Gluon MLP trained on the
    blobs, its weights to uint8 and back, the accuracy drop at most 0.02;
    the codes bit for bit the CPU's for the same weights."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon import nn
    n, ncls, dim, epochs = QUANT_MLP
    ctx = _ctx_of(device)
    mt.random.seed(10)
    rng = np.random.RandomState(23)
    centers = rng.randn(ncls, dim).astype(np.float32) * 1.6

    def blobs(k):
        lab = rng.randint(0, ncls, k)
        x = centers[lab] + 0.45 * rng.randn(k, dim).astype(np.float32)
        return x.astype(np.float32), lab.astype(np.float32)
    xtr, ytr = blobs(n)
    xte, yte = blobs(n // 4)
    with ctx:
        net = nn.Sequential()
        with net.name_scope():
            net.add(nn.Dense(64, activation='relu'), nn.Dense(ncls))
        net.initialize(mt.init.Xavier(), ctx=ctx)
        trainer = gluon.Trainer(net.collect_params(), 'sgd',
                                {'learning_rate': 0.1, 'momentum': 0.9})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        for _ in range(epochs):
            perm = rng.permutation(len(xtr))
            for i in range(0, len(xtr), 64):
                idx = perm[i:i + 64]
                with autograd.record():
                    loss = loss_fn(net(mt.nd.array(xtr[idx])),
                                   mt.nd.array(ytr[idx]))
                loss.backward()
                trainer.step(len(idx))

        def accuracy():
            return float((net(mt.nd.array(xte)).asnumpy().argmax(1) ==
                          yte).mean())
        acc32 = accuracy()
        stored = {}
        for name, p in net.collect_params().items():
            w = p.data()
            w_np = w.asnumpy()
            lo, hi = float(w_np.min()), float(w_np.max()) + 1e-8
            stored[name] = mt.nd.contrib.quantize(
                w, mt.nd.array([lo]), mt.nd.array([hi]), out_type='uint8')
            with mt.cpu():
                want = mt.nd.contrib.quantize(
                    mt.nd.array(w_np), mt.nd.array([lo]), mt.nd.array([hi]),
                    out_type='uint8')[0]
            _exact(stored[name][0].handle, want.handle, 'uint8 codes of '
                   + name)
        for name, p in net.collect_params().items():
            q, qmin, qmax = stored[name]
            p.set_data(mt.nd.contrib.dequantize(q, qmin, qmax).reshape(
                p.data().shape))
        acc8 = accuracy()
    check(acc32 > 0.9 and acc32 - acc8 <= 0.02, 'quantize_mlp: f32 accuracy '
          '%.3f, uint8 %.3f' % (acc32, acc8))
    log('    quantize_mlp.py: accuracy %.3f in f32, %.3f from uint8 codes '
        '(bit for bit the CPU\'s)' % (acc32, acc8))


def resnet_uint8(device):
    """bench's resnet50_v1 parameters (bench's host init from RandomState(0))
    to uint8 codes and back on the card, each code bit for bit the CPU's.
    Returns the ms of the quantize of all parameters."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch import graph_train
    with mt.name.NameManager():
        net = vision.get_model('resnet50_v1', classes=1000)
    prog, arg_shapes, _ = graph_train.build_graph(net, (1, 3, 224, 224))
    rng = np.random.RandomState(0)
    params = [graph_train.host_init(n, s, rng)
              for n, s in zip(prog.arg_names, arg_shapes) if n != 'data']
    total = sum(p.size for p in params)
    ctx = _ctx_of(device)

    def quantize_all(arrays):
        outs = []
        for a in arrays:
            lo, hi = a.min(), a.max()
            q = mt.nd.contrib.quantize(a, lo.reshape((1,)), hi.reshape((1,)),
                                       out_type='uint8')
            outs.append((q[0], mt.nd.contrib.dequantize(*q)))
        return outs
    card = [mt.nd.array(p, ctx=ctx) for p in params]
    with mt.cpu():
        host = quantize_all([mt.nd.array(p) for p in params])
    got = quantize_all(card)
    err = 0.0
    for (q, d), (wq, wd) in zip(got, host):
        _exact(q.handle, wq.handle, 'a resnet50_v1 parameter\'s uint8 codes')
        err = max(err, _held(d.handle, wd.handle, CONTRIB_RTOL,
                             'a dequantized parameter'))
    ms = device_ms(lambda: quantize_all(card), runs=3)
    log('    bench\'s resnet50_v1: %d parameters (%d arrays) to uint8 and '
        'back: codes bit for bit the CPU\'s, dequantized within %.2e; %.3f '
        'ms (CUDA events)' % (total, len(card), err, ms))
    return ms


def contrib_rest(device):
    """Phase (t6): quantize_mlp.py, resnet50_v1's parameters in uint8, then
    DeformableConvolution, PSROIPooling and DeformablePSROIPooling,
    Correlation, the spatial transformer's three ops, fft/ifft,
    count_sketch and IdentityAttachKLSparseReg at their widths, each
    forward (and backward) against the CPU. Returns {op: (fwd ms, fwd+bwd
    ms)}."""
    import torch
    quantize_mlp(device)
    ms = {'quantize resnet50_v1': (resnet_uint8(device), None)}
    g = torch.Generator(device='cpu').manual_seed(13)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    N, C, H, W = DEFORM_SHAPE
    off = randn(N, 18, H, W, scale=2.0)
    ms['DeformableConvolution'] = _op_vs_cpu(
        device, '_contrib_DeformableConvolution',
        {'kernel': (3, 3), 'pad': (2, 2), 'dilate': (2, 2), 'num_filter': C,
         'no_bias': False},
        [randn(N, C, H, W), off, randn(C, C, 3, 3, scale=0.02),
         randn(C)], grad_of=(0, 1, 2, 3),
        sub=lambda ins: [ins[0][:DEFORM_CPU], ins[1][:DEFORM_CPU], ins[2],
                         ins[3]], runs=3)

    prob, bbox, info = rpn_inputs()
    import mxnet_tpu_torch as mt
    with mt.cpu():
        rois = mt.nd.contrib.MultiProposal(
            *(mt.nd.array(a) for a in (prob, bbox, info)),
            scales=RPN_SCALES, ratios=RPN_RATIOS).handle
    dim = RFCN_DIM * RFCN_GROUP * RFCN_GROUP
    maps = randn(RPN_IMAGES, dim, *RPN_MAP)
    first = lambda ins: [ins[0], ins[1][:ROI_CPU]] + [t[:ROI_CPU]
                                                      for t in ins[2:]]
    ms['PSROIPooling'] = _op_vs_cpu(
        device, '_contrib_PSROIPooling',
        {'spatial_scale': 1.0 / 16, 'output_dim': RFCN_DIM,
         'pooled_size': RFCN_GROUP, 'group_size': RFCN_GROUP},
        [maps, rois], grad_of=(0,), sub=first)
    ms['DeformablePSROIPooling'] = _op_vs_cpu(
        device, '_contrib_DeformablePSROIPooling',
        {'spatial_scale': 1.0 / 16, 'output_dim': RFCN_DIM,
         'group_size': RFCN_GROUP, 'pooled_size': RFCN_GROUP,
         'sample_per_part': RFCN_SPP, 'trans_std': RFCN_TSTD},
        [maps, rois, randn(rois.shape[0], 2, RFCN_GROUP, RFCN_GROUP)],
        grad_of=(0, 2), sub=first)
    a, b = randn(*FLOW_SHAPE), randn(*FLOW_SHAPE)
    ms['Correlation'] = _op_vs_cpu(
        device, 'Correlation', {'max_displacement': FLOW_DISP,
                                'stride2': FLOW_STRIDE2, 'kernel_size': 1},
        [a, b], grad_of=(0, 1),
        sub=lambda ins: [t[:FLOW_CPU] for t in ins], runs=3)
    img = randn(*STN_SHAPE)
    loc = torch.tensor([[0.9, 0.1, 0.05, -0.1, 0.95, 0.0]]).repeat(
        STN_SHAPE[0], 1) + randn(STN_SHAPE[0], 6, scale=0.05)
    stn = lambda ins: [t[:STN_CPU] for t in ins]
    ms['SpatialTransformer'] = _op_vs_cpu(
        device, 'SpatialTransformer', {'target_shape': STN_SHAPE[2:]},
        [img, loc], grad_of=(0, 1), sub=stn)
    ms['GridGenerator'] = _op_vs_cpu(
        device, 'GridGenerator', {'transform_type': 'affine',
                                  'target_shape': STN_SHAPE[2:]},
        [loc], grad_of=(0,), sub=stn)
    grid = randn(STN_SHAPE[0], 2, *STN_SHAPE[2:], scale=0.6)
    ms['BilinearSampler'] = _op_vs_cpu(
        device, 'BilinearSampler', {}, [img, grid], grad_of=(0, 1), sub=stn)
    x = randn(*FFT_SHAPE)
    ms['fft'] = _op_vs_cpu(device, '_contrib_fft', {}, [x], grad_of=(0,))
    ms['ifft'] = _op_vs_cpu(device, '_contrib_ifft', {},
                            [randn(FFT_SHAPE[0], 2 * FFT_SHAPE[1])],
                            grad_of=(0,))
    h = torch.from_numpy(np.random.RandomState(14).randint(
        0, SKETCH_DIM, (1, SKETCH_SHAPE[1])).astype(np.float32))
    s = torch.from_numpy(np.random.RandomState(15).choice(
        [-1.0, 1.0], (1, SKETCH_SHAPE[1])).astype(np.float32))
    ms['count_sketch'] = _op_vs_cpu(
        device, '_contrib_count_sketch', {'out_dim': SKETCH_DIM},
        [randn(*SKETCH_SHAPE), h, s], grad_of=(0, 2))
    act = torch.sigmoid(randn(*KL_SHAPE))
    ms['IdentityAttachKLSparseReg'] = _op_vs_cpu(
        device, 'IdentityAttachKLSparseReg', {'__is_train__': True},
        [act, torch.full((KL_SHAPE[1],), 0.5)], grad_of=(0,))
    log('    each forward (and backward) held against the CPU: values within '
        '%.0e, gradients within %.0e (DeformableConvolution, Correlation '
        'and the samplers on their first samples, the poolings on their '
        'first %d rois); ms (CUDA events; forward, forward + backward):'
        % (CONTRIB_RTOL, CONTRIB_GRAD_RTOL, ROI_CPU))
    for k, (f, fb) in ms.items():
        log('      %s: %.3f%s' % (k, f, '' if fb is None else ', %.3f' % fb))
    return ms


def phase_t(device, work):
    """Phase (t): (t1) the sparse linear classifier at Avazu's width, (t2)
    sparse storage round trips, (t3) the sparse head through K3 and K5,
    (t4) SSD, (t5) Faster R-CNN, (t6) the other contrib ops. Returns
    ({wrapper: (t3)'s launches}, {wrapper: launches over (t4)-(t6)},
    {figure: ms})."""
    import torch
    t0 = time.perf_counter()
    figures = {}
    if device.type == 'cuda':
        # (t2) holds a 32.8 GB dense array: hand the earlier phases' cached
        # blocks back first
        torch.cuda.empty_cache()
    log('  (t1) the sparse linear classifier at Avazu\'s width')
    path, _ = sparse_classifier(device, work)
    log('  (t2) sparse storage round trips on the card')
    storage_round_trips(device, path, work)
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    log('  (t3) a sparse multi-class head through K3 and K5')
    sparse_launches, figures['sparse head ms a batch'] = sparse_head(
        device, path)
    counters = _staged_counters()
    _zero_counts(counters)
    log('  (t4) SSD: train_ssd.py, then the MultiBox ops at SSD300\'s widths')
    ssd_fit(device, work)
    figures.update(ssd300_ops(device))
    log('  (t5) Faster R-CNN: train_rcnn_lite.py, then MultiProposal and '
        'ROIPooling at its widths')
    rcnn_fit(device)
    figures.update(rpn_and_roi_pooling(device))
    log('  (t6) the other contrib ops')
    figures.update(contrib_rest(device))
    contrib_launches = _counts(counters)
    log('  kernel launches over (t4)-(t6): %s' % contrib_launches)
    log('  phase (t) took %.1f s' % (time.perf_counter() - t0))
    return sparse_launches, contrib_launches, figures


# ---------------------------------------------------------------------------
# (u) the resilience tier on the card
# ---------------------------------------------------------------------------

RES_BATCHES = 12        # (u1): train_imagenet's recipe, 12 batches of 32
RES_EVERY = 4           # (u1): a checkpoint every 4 steps
RES_FAULT = 'nan-grad:6'
RES_HEAD_BATCHES = 8    # (u2), (u3): (l2)'s head, two windows of 4
RES_HEAD_EVERY = 2
RES_HEAD_FAULT = 'dispatch-exception:5'
RES_ROW_RTOL = 1e-5     # (u2): a sentinel row against its recomputation
CHILD_BATCHES = 12      # (u4): the supervised child, three windows of 4
CHILD_WATCHDOG_S = 5.0
CHILD_TIMEOUT_S = 300


class _resilience_env(_flags_set):
    """_flags_set for the resilience tier's flags, with the telemetry and
    fault-injection state (each decided once a process) reset on the way
    in and out."""

    def _reset(self):
        from mxnet_tpu_torch import faults, telemetry
        telemetry._reset_for_tests()
        faults._reset_for_tests()

    def __enter__(self):
        super().__enter__()
        self._reset()

    def __exit__(self, *exc):
        self._reset()
        super().__exit__(*exc)


def _train_state(mod):
    """{name: tensor} of a module's parameters, aux states and optimizer
    states (the momenta), cloned."""
    from mxnet_tpu_torch.module.fused_fit import updater_obj, updater_keys
    args, aux = mod.get_params()
    out = {n: a.handle.detach().clone() for n, a in
           list(args.items()) + list(aux.items())}
    e = mod._exec_group.execs[0]
    keys = updater_keys(mod, e._grad_names)
    states = updater_obj(mod).states

    def walk(st, name):
        if st is None:
            return
        if isinstance(st, tuple):
            for i, s in enumerate(st):
                walk(s, '%s.%d' % (name, i))
            return
        out[name] = st.handle.detach().clone()
    for n in e._grad_names:
        walk(states.get(keys[n]), 'state:' + n)
    return out


def _same_state(got, want):
    """The names whose tensors are not bit for bit equal."""
    import torch
    return sorted(n for n in set(got) | set(want)
                  if n not in got or n not in want
                  or not torch.equal(got[n].cpu(), want[n].cpu()))


def _ckpt_bytes(directory):
    """Bytes of the newest committed step of a checkpoint directory."""
    steps = sorted(int(n) for n in os.listdir(directory) if n.isdigit())
    d = os.path.join(directory, str(steps[-1]))
    return steps[-1], sum(os.path.getsize(os.path.join(d, f))
                          for f in os.listdir(d))


def _callback_ms(stamps, every):
    """A batch's host ms: the median wall between the callbacks ``every``
    batches apart (a window's burst to the next), over the batches."""
    gaps = [(stamps[i + every] - stamps[i]) * 1e3 / every
            for i in range(0, len(stamps) - every, every)]
    return statistics.median(gaps) if gaps else float('nan')


def resilient_resnet(device, work, fused, spec=RESNET,
                     n_batches=RES_BATCHES):
    """Phase (u1) on one loop (the window when ``fused``, else the
    per-batch loop): train_imagenet's recipe on ResNet-50 through
    resilient_fit with checkpoints every RES_EVERY steps, health (raise)
    and nan-grad at batch 6, against the uninterrupted run from the same
    masters; returns {figure: value}."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.module.resilient_fit import resilient_fit
    name, batch, image, classes = spec
    on_card = device.type == 'cuda'
    ctx = mt.gpu(device.index or 0) if on_card else mt.cpu()
    loop = 'window' if fused else 'per-batch'
    rng = np.random.RandomState(0)
    X = rng.standard_normal((n_batches * batch, 3, image, image)).astype(
        np.float32)
    y = rng.randint(0, classes, n_batches * batch).astype(np.int32)
    sym = _zoo_symbol(name, classes, (batch, 3, image, image))
    tele = os.path.join(work, 'u1_%s.jsonl' % loop)
    ckdir = os.path.join(work, 'u1_%s_ckpt' % loop)
    fused_flag = '1' if fused else '0'

    def run(faulted):
        train = mt.io.NDArrayIter(X, y, batch_size=batch)
        mod = mt.mod.Module(sym) if on_card else \
            mt.mod.Module(sym, context=ctx)
        mod.bind(train.provide_data, train.provide_label)
        mt.random.seed(0)
        mod.init_params(_xavier())
        stamps = []
        windows = []
        kw = dict(num_epoch=1, optimizer='sgd', optimizer_params=FIT_OPT,
                  eval_metric=['acc'], kvstore='device',
                  batch_end_callback=lambda p: stamps.append(
                      time.perf_counter()))
        with _timed_windows(device, windows):
            if faulted:
                with _resilience_env(
                        MXTPU_FUSED_FIT=fused_flag, MXTPU_TELEMETRY='1',
                        MXTPU_TELEMETRY_PATH=tele, MXTPU_HEALTH='1',
                        MXTPU_HEALTH_ACTION='raise', MXTPU_CKPT_DIR=ckdir,
                        MXTPU_CKPT_EVERY=str(RES_EVERY),
                        MXTPU_FAULT_INJECT=RES_FAULT,
                        MXTPU_RESTART_BACKOFF='0'):
                    restarts = resilient_fit(mod, train, **kw)
                    ck = mod.__dict__['_mxtpu_ckpt']
                    hs = telemetry.health.snapshot_health()
                    span = telemetry.get_registry().get('ckpt.save')
                    figures = {
                        'restarts': restarts,
                        'restored_step': ck.restored_step,
                        'last_good': ck.last_good,
                        'incident': hs['incidents'][0] if hs['incidents']
                        else {},
                        'save_ms': (span.count, span.mean, span.max)
                        if span is not None else None}
            else:
                with _flags_set(MXTPU_FUSED_FIT=fused_flag):
                    mod.fit(train, **kw)
                figures = {}
        if on_card:
            torch.cuda.synchronize()
        figures['state'] = _train_state(mod)
        figures['stamps'] = stamps
        figures['syncs'] = [s for _, _, ss, _ in windows for s in ss]
        figures['windows'] = len(windows)
        return figures

    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        off = run(False)
        t_off = time.perf_counter() - t0
        t0 = time.perf_counter()
        on = run(True)
        t_on = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    inc = on['incident']
    step, size = _ckpt_bytes(ckdir)
    diff = _same_state(on['state'], off['state'])
    every = 4 if fused else 1
    log('  (u1) %s loop: the faulted run (%.1f s) took %d restart, restored '
        'step %s, last good %s; the incident names step %s (%s, window step '
        '%s), first non-finite symbol %s; %d state tensors (parameters, aux '
        'states, momenta) %s the uninterrupted run\'s (%.1f s); a '
        'checkpoint of step %d is %d bytes (%.1f MB)'
        % (loop, t_on, on['restarts'], on['restored_step'], on['last_good'],
           inc.get('step'), inc.get('source'), inc.get('window_step'),
           inc.get('first_bad_layer'), len(on['state']),
           'bit for bit' if not diff else 'NOT bit for bit (%s)' % diff[:3],
           t_off, step, size, size / 1e6))
    log('      a batch\'s host ms (callback to callback, %s): %.3f with '
        'checkpoints and sentinels on, %.3f off; the ckpt.save span '
        '(writer thread): %s; synchronising calls inside the windows: %s'
        % ('window to window over W' if fused else 'median',
           _callback_ms(on['stamps'][-8:], every),
           _callback_ms(off['stamps'], every),
           'count %d, mean %.3f ms, max %.3f ms' % on['save_ms']
           if on['save_ms'] else 'none', len(on['syncs']) if on_card
           else 'not measured off the card'))
    check(on['restarts'] == 1 and on['restored_step'] == 4,
          '(u1) %s: %s restarts from step %s, not 1 from step 4'
          % (loop, on['restarts'], on['restored_step']))
    check(inc.get('step') == 6 and inc.get('first_bad_layer') == 'data',
          '(u1) %s: the incident is %s' % (loop, inc))
    check(not diff, '(u1) %s: the final state differs from the '
          'uninterrupted run\'s in %s' % (loop, diff[:5]))
    check(not on['syncs'] and not off['syncs'],
          '(u1) a window synchronised with the device: %s'
          % (on['syncs'] + off['syncs'])[:3])
    if fused:
        # the faulted run: windows 1 and 2, then 2 and 3 again after the
        # restore
        check(on['windows'] == 4 and off['windows'] == 3,
              '(u1) the window ran %d and %d windows'
              % (on['windows'], off['windows']))
    return {'ckpt_bytes': size, 'on_ms': _callback_ms(on['stamps'][-8:],
                                                      every),
            'off_ms': _callback_ms(off['stamps'], every),
            'save_ms': on['save_ms']}


def _head_module(mt, ctx, V):
    sym = mt.sym
    x = sym.var('x')
    logits = sym.Cast(sym.FullyConnected(sym.LayerNorm(x, name='ln'),
                                         num_hidden=V, no_bias=True,
                                         name='head'), dtype='float32')
    net = sym.MakeLoss(sym.softmax_cross_entropy(logits, sym.var('label')))
    return mt.mod.Module(net, data_names=('x',), label_names=('label',),
                         context=ctx)


def _head_shape(cfg):
    """(N, D, V): (l2)'s head's rows, width and classes."""
    return MAX_BATCH * cfg.seq_len, cfg.d_model, cfg.vocab


def _head_data(shape, batches, seed=23):
    N, D, V = shape
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((batches * N, D)).astype(np.float32)
    y = rng.randint(0, V, batches * N).astype(np.int32)
    return X, y, N


def _head_fit(mt, ctx, V, X, y, N, num_epoch=1, callback=None,
              resilient=False):
    """(l2)'s head through the windowed Module.fit from Xavier at seed 0;
    returns (module, restarts)."""
    from mxnet_tpu_torch.module.resilient_fit import resilient_fit
    it = mt.io.NDArrayIter({'x': X}, {'label': y}, batch_size=N)
    mod = _head_module(mt, ctx, V)
    mod.bind(it.provide_data, it.provide_label)
    mt.random.seed(0)
    mod.init_params(_xavier())
    kw = dict(num_epoch=num_epoch, optimizer='sgd', optimizer_params=FIT_OPT,
              eval_metric='loss', kvstore='device',
              batch_end_callback=callback)
    if resilient:
        return mod, resilient_fit(mod, it, **kw)
    mod.fit(it, **kw)
    return mod, 0


def resilient_head(device, cfg, work, batches=RES_HEAD_BATCHES):
    """Phase (u2): (l2)'s head through the windowed Module.fit with health
    and dynamics on, checkpoints every RES_HEAD_EVERY steps and
    dispatch-exception at step 5, under resilient_fit; each batch's loss
    against the plain versions' trajectory, the final state against the
    uninterrupted run, window step 0's sentinel row against its
    recomputation from that step's gradients. Returns ({wrapper: launches
    over the faulted run}, the uninterrupted run's state)."""
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.ops import cuda_kernels as ck
    from mxnet_tpu_torch.ops import registry
    on_card = device.type == 'cuda'
    ctx = mt.gpu(device.index or 0) if on_card else mt.cpu()
    V = cfg.vocab
    X, y, N = _head_data(_head_shape(cfg), batches)
    sums = []
    rows = []
    real_note = telemetry.health.note_window

    def spy(hmat, *a, **k):
        rows.append(np.asarray(hmat))
        return real_note(hmat, *a, **k)

    counters = (ck.layernorm_fwd, ck.rmsnorm_fwd, ck.softmax_fwd,
                ck.softmax_xent_fwd)
    windows = []
    tele = os.path.join(work, 'u2.jsonl')
    telemetry.health.note_window = spy
    try:
        with _timed_windows(device, windows), _resilience_env(
                MXTPU_TELEMETRY='1', MXTPU_TELEMETRY_PATH=tele,
                MXTPU_HEALTH='1', MXTPU_HEALTH_ACTION='raise',
                MXTPU_DYNAMICS='1',
                MXTPU_CKPT_DIR=os.path.join(work, 'u2_ckpt'),
                MXTPU_CKPT_EVERY=str(RES_HEAD_EVERY),
                MXTPU_FAULT_INJECT=RES_HEAD_FAULT,
                MXTPU_RESTART_BACKOFF='0'):
            # the main path: counts are zeroed just before and read just
            # after
            _zero_counts(counters)
            mod, restarts = _head_fit(
                mt, ctx, V, X, y, N, resilient=True,
                callback=lambda p: sums.append(p.eval_metric.sum_metric))
            if on_card:
                torch.cuda.synchronize()
            launches = _counts(counters)
            ck_ = mod.__dict__['_mxtpu_ckpt']
            restored = ck_.restored_step
            dyn = telemetry.dynamics.snapshot_dynamics()
            hsteps = telemetry.get_registry().counter('health.steps').value
    finally:
        telemetry.health.note_window = real_note
    state = _train_state(mod)
    ref_mod, _ = _head_fit(mt, ctx, V, X, y, N)
    ref_state = _train_state(ref_mod)
    diff = _same_state(state, ref_state)
    losses = list(np.diff([0.0] + sums))
    want = {'layernorm_fwd': batches, 'rmsnorm_fwd': 0, 'softmax_fwd': 0,
            'softmax_xent_fwd': batches}
    if not on_card:
        want = dict.fromkeys(want, 0)
    syncs = [s for _, _, ss, _ in windows for s in ss]
    log('  (u2) Module(x [%d, %d] f32 -> LayerNorm -> FullyConnected to %d '
        '-> f32 -> softmax_cross_entropy -> MakeLoss), %d batches under '
        'resilient_fit with %s: %d restart from step %s; launches over the '
        'run %s (one K4 and one K3 a trained step); %d health rows checked, '
        'dynamics over %s steps (worst layer %s); %d state tensors %s the '
        'uninterrupted run\'s; synchronising calls inside the windows: %s'
        % (N, cfg.d_model, cfg.vocab, batches, RES_HEAD_FAULT, restarts,
           restored, launches, hsteps, dyn and dyn['steps'],
           dyn and dyn.get('worst_layer'), len(state),
           'bit for bit' if not diff else 'NOT bit for bit (%s)' % diff[:3],
           len(syncs) if on_card else 'not measured off the card'))
    check(restarts == 1 and restored == 4,
          '(u2) %s restarts from step %s' % (restarts, restored))
    check(launches == want, '(u2) launches %s != %s' % (launches, want))
    check(hsteps == batches and dyn is not None and dyn['steps'] == batches,
          '(u2) the sentinels saw %s / %s rows' % (hsteps, dyn))
    check(not diff, '(u2) the final state differs from the uninterrupted '
          'run\'s in %s' % diff[:5])
    check(not syncs, '(u2) a window synchronised with the device: %s'
          % syncs[:3])

    # each batch's loss against the plain versions' trajectory, and window
    # step 0's sentinel row against its recomputation from that step's
    # gradients (the executor's backward on the same module state and
    # batch: the same kernels and the same update op the window runs)
    def plain_loss(p, xb, lab):
        h = ck.layernorm_ref(xb, p['ln_gamma'], p['ln_beta'])
        return ck.softmax_xent_ref((h @ p['head_weight'].t()).float(),
                                   lab).sum()

    sgd = registry.get('sgd_mom_update').fn
    chk = _head_module(mt, ctx, V)
    it = mt.io.NDArrayIter({'x': X}, {'label': y}, batch_size=N)
    chk.bind(it.provide_data, it.provide_label)
    mt.random.seed(0)
    chk.init_params(_xavier())
    p0 = {n: a.handle.detach().clone() for n, a in chk.get_params()[0].items()}

    def wd(n):
        return FIT_OPT['wd'] if n.endswith(('_weight', '_gamma')) else 0.0

    chk.forward_backward(next(iter(it)))
    e = chk._exec_group.execs[0]
    g0 = {n: e.grad_dict[n].handle.detach() for n in e._grad_names}
    new0 = {n: sgd(dict(lr=FIT_OPT['learning_rate'],
                        momentum=FIT_OPT['momentum'], wd=wd(n),
                        rescale_grad=1.0 / N, clip_gradient=-1.0),
                   p0[n], g0[n], torch.zeros_like(p0[n]))[0]
            for n in e._grad_names}

    def norm(ts):
        return math.sqrt(sum(float(t.double().square().sum()) for t in ts))

    pn = norm(p0[n] for n in e._grad_names)
    recomputed = np.array([1.0, norm(g0.values()), pn,
                           norm(new0[n] - p0[n] for n in e._grad_names) / pn,
                           1.0])
    row = rows[0][0].astype(np.float64)
    row_err = float(np.max(np.abs(row - recomputed) / np.abs(recomputed)))
    p = dict(p0)
    mom = {n: torch.zeros_like(t) for n, t in p.items()}
    ref = []
    for b in range(batches):
        xb = torch.from_numpy(X[b * N:(b + 1) * N]).to(device)
        lab = torch.from_numpy(y[b * N:(b + 1) * N]).to(device)
        leaves = {n: t.detach().requires_grad_() for n, t in p.items()}
        loss = plain_loss(leaves, xb, lab)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        ref.append(float(loss.detach()))
        with torch.no_grad():
            for (n, t), g in zip(p.items(), grads):
                attrs = dict(lr=FIT_OPT['learning_rate'],
                             momentum=FIT_OPT['momentum'], wd=wd(n),
                             rescale_grad=1.0 / N, clip_gradient=-1.0)
                p[n], mom[n] = sgd(attrs, t, g, mom[n])
    errs = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    log('      each batch\'s loss against the plain versions\' trajectory '
        'from the same parameters: relative errors %s; window step 0\'s '
        'sentinel row %s against its recomputation %s (relative error '
        '%.3e, held to %g)'
        % (['%.3e' % v for v in errs], ['%.6g' % v for v in row],
           ['%.6g' % v for v in recomputed], row_err, RES_ROW_RTOL))
    check(len(errs) == batches and max(errs) <= WINDOW_LOSS_RTOL,
          '(u2) a batch\'s loss disagrees with the plain versions')
    check(row_err <= RES_ROW_RTOL, '(u2) the sentinel row disagrees with '
          'its recomputation')
    del mod, ref_mod, chk
    return launches


def corrupt_fallback(device, cfg, work, batches=RES_HEAD_BATCHES):
    """Phase (u3): checkpoint-corrupt on the head's step-8 checkpoint; a
    fresh fit of two epochs falls back to step 4 and ends bit for bit on
    the uninterrupted two-epoch run."""
    import mxnet_tpu_torch as mt
    on_card = device.type == 'cuda'
    ctx = mt.gpu(device.index or 0) if on_card else mt.cpu()
    V = cfg.vocab
    X, y, N = _head_data(_head_shape(cfg), batches)
    ckdir = os.path.join(work, 'u3_ckpt')
    env = dict(MXTPU_CKPT_DIR=ckdir, MXTPU_CKPT_EVERY=str(RES_HEAD_EVERY))
    with _resilience_env(MXTPU_FAULT_INJECT='checkpoint-corrupt:8', **env):
        _head_fit(mt, ctx, V, X, y, N)
    with _resilience_env(**env):
        mod, _ = _head_fit(mt, ctx, V, X, y, N, num_epoch=2)
    restored = mod.__dict__['_mxtpu_ckpt'].restored_step
    ref, _ = _head_fit(mt, ctx, V, X, y, N, num_epoch=2)
    diff = _same_state(_train_state(mod), _train_state(ref))
    log('  (u3) checkpoint-corrupt:8 truncated step 8; the next fit '
        'restored step %s and ended %s the uninterrupted run'
        % (restored, 'bit for bit on' if not diff else
           'NOT bit for bit on (%s)' % diff[:3]))
    check(restored == 4, '(u3) restored step %s, not 4' % restored)
    check(not diff, '(u3) the resumed run differs in %s' % diff[:5])
    del mod, ref


def resilience_child():
    """(u4)'s training child: (l2)'s head (its N, D, V in CHILD_HEAD)
    through the windowed Module.fit for CHILD_BATCHES batches on
    CHILD_DEVICE (the parent's: the card), its parameters, aux states and
    momenta saved to CHILD_OUT. A relaunch clears the one-shot fault from
    its own environment (CHILD_MARKER counts the attempts)."""
    import torch
    marker = os.environ['CHILD_MARKER']
    first = not os.path.exists(marker)
    with open(marker, 'a') as f:
        f.write('x\n')
    if not first:
        os.environ.pop('MXTPU_FAULT_INJECT', None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import mxnet_tpu_torch as mt
    shape = tuple(int(v) for v in os.environ['CHILD_HEAD'].split(','))
    dev = torch.device(os.environ['CHILD_DEVICE'])
    ctx = mt.gpu(dev.index or 0) if dev.type == 'cuda' else mt.cpu()
    X, y, N = _head_data(shape, CHILD_BATCHES, seed=24)
    mod, _ = _head_fit(mt, ctx, shape[2], X, y, N)
    torch.save({n: t.cpu() for n, t in _train_state(mod).items()},
               os.environ['CHILD_OUT'])


def _child_env(work, tag, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('MXTPU_')}
    d = os.path.join(work, tag)
    os.makedirs(d)
    env.update({'PYTHONPATH': os.path.dirname(os.path.abspath(__file__)),
                'CHILD_MARKER': os.path.join(d, 'marker'),
                'CHILD_OUT': os.path.join(d, 'state.pt')})
    env.update(extra)
    return env, d


def supervised_children(device, cfg, work):
    """Phase (u4): ``python -m mxnet_tpu_torch.train_supervisor`` over
    resilience_child on the card, once with host-loss (exit 113) and once
    with hang under the watchdog's abort (exit 85), beside an
    uninterrupted child, all three at once; each relaunch resumes from the
    certified pointer and saves the uninterrupted child's state bit for
    bit."""
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    child = [sys.executable, '-c',
             'import chip_smoke; chip_smoke.resilience_child()']
    sup = [sys.executable, '-m', 'mxnet_tpu_torch.train_supervisor',
           '--backoff', '0', '--']
    runs = {}
    for tag, fault, extra in (
            ('reference', None, {}),
            # synchronous saves: step 4 is certified at step 8's note
            ('host-loss', 'host-loss:9', {'MXTPU_CKPT_ASYNC': '0'}),
            ('hang', 'hang:9:120', {
                'MXTPU_WATCHDOG_SECS': str(CHILD_WATCHDOG_S),
                'MXTPU_WATCHDOG_ACTION': 'abort'})):
        env, d = _child_env(work, 'u4_' + tag)
        env['CHILD_HEAD'] = ','.join(str(v) for v in _head_shape(cfg))
        env['CHILD_DEVICE'] = str(device)
        if fault:
            env.update({'MXTPU_TELEMETRY': '1',
                        'MXTPU_TELEMETRY_PATH': os.path.join(d, 'tele.jsonl'),
                        'MXTPU_CKPT_DIR': os.path.join(d, 'ckpt'),
                        'MXTPU_CKPT_EVERY': str(RES_HEAD_EVERY),
                        'MXTPU_FAULT_INJECT': fault}, **extra)
        cmd = (sup if fault else []) + child
        runs[tag] = (d, time.perf_counter(), subprocess.Popen(
            cmd, cwd=here, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out = {}
    try:
        for tag, (d, t0, proc) in runs.items():
            so, se = proc.communicate(timeout=CHILD_TIMEOUT_S)
            out[tag] = (d, proc.returncode, se, time.perf_counter() - t0)
    finally:
        for _, _, proc in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    d, code, se, _ = out['reference']
    check(code == 0, '(u4) the uninterrupted child failed: %s' % se[-2000:])
    want = torch.load(os.path.join(d, 'state.pt'))
    for tag, exit_code in (('host-loss', 113), ('hang', 85)):
        d, code, se, wall = out[tag]
        recs = _jsonl(os.path.join(d, 'tele.jsonl'))
        restarts = [r for r in recs if r['type'] == 'restart'
                    and not r.get('final')]
        resumes = [r for r in recs if r.get('name') == 'ckpt.resume']
        drained = [int(s) for s in
                   re.findall(r'abort drain certified step (\d+)', se)]
        got = torch.load(os.path.join(d, 'state.pt')) if code == 0 else {}
        diff = _same_state(got, want)
        restored = resumes[0]['restored_step'] if resumes else None
        log('  (u4) %s: the supervisor exited %s after %.1f s; the child '
            'died with %s, was relaunched and restored step %s%s; its %d '
            'state tensors %s the uninterrupted child\'s'
            % (tag, code, wall, [r['exit_code'] for r in restarts],
               restored, '; the abort hook certified step %s' % drained
               if tag == 'hang' else '', len(got),
               'bit for bit' if not diff else
               'NOT bit for bit (%s)' % diff[:3]))
        check(code == 0, '(u4) %s: the supervisor exited %s: %s'
              % (tag, code, se[-2000:]))
        check([r['exit_code'] for r in restarts] == [exit_code],
              '(u4) %s: restart records %s' % (tag, restarts))
        check(len(resumes) == 1 and restored is not None and restored >= 4,
              '(u4) %s: the relaunch did not resume (%s)' % (tag, resumes))
        if tag == 'hang':
            check(drained == [restored] and restored in (4, 8),
                  '(u4) hang: the abort hook certified %s, the relaunch '
                  'restored %s' % (drained, restored))
        else:
            check(restored == 4, '(u4) host-loss: restored %s' % restored)
        check(not diff, '(u4) %s: the relaunched child\'s state differs in '
              '%s' % (tag, diff[:5]))


def phase_u(device, cfg, work):
    """Phase (u): (u1) ResNet-50 through resilient_fit on the window and
    the per-batch loop, (u2) the decoder head with the sentinels, (u3)
    checkpoint-corrupt, (u4) the process tier. Returns {wrapper: (u2)'s
    launches}."""
    import torch
    t0 = time.perf_counter()
    figures = {}
    log('  (u1) train_imagenet\'s recipe through resilient_fit with %s'
        % RES_FAULT)
    for fused in (True, False):
        figures['window' if fused else 'per-batch'] = resilient_resnet(
            device, work, fused)
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    launches = resilient_head(device, cfg, work)
    corrupt_fallback(device, cfg, work)
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    supervised_children(device, cfg, work)
    log('  phase (u) took %.1f s' % (time.perf_counter() - t0))
    return launches, figures


def main():
    # phase (l1)'s checkpoint, phase (n)'s head and its telemetry logs
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as work:
        return run(work)


def run(work):
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; this script runs on the card',
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.transformer import TransformerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # CUPTI stays set up between this script's torch.profiler captures (as
    # mx.profiler keeps it, profiler._start_capture): torn down and set up
    # again lazily, a later capture lost kernel records from its start
    os.environ.setdefault('TEARDOWN_CUPTI', '0')
    device = torch.device('cuda', 0)
    t_start = time.perf_counter()

    log('(a) identity')
    card = card_identity()
    log(card)
    log('  torch %s, CUDA %s, %s' % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))

    log('(b) build')
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:    # one nvcc per source
        list(pool.map(_build.load, SOURCES))
    log('  %s built and loaded in %.1f s'
        % (', '.join(n + '.cu' for n in SOURCES), time.perf_counter() - t0))
    for name in SOURCES:
        for line in _build.build_log(name).splitlines():
            if 'Function properties' in line or 'registers' in line or 'spill' in line:
                log('   ', line.strip())

    cfg = TransformerConfig()

    log('(c) flash kernel vs plain version')
    errs = kernel_vs_plain(device)

    log('(g) row kernels vs plain versions')
    row_kernels_vs_plain(device, cfg)

    log('(d) serving at full width')
    model, ref, launches, latencies, worst = serve(device, cfg, SERVE_ROWS,
                                                   MAX_BATCH)
    for rows, (sec, tm) in zip(SERVE_ROWS, latencies):
        log('  request of %2d rows: %.2f ms (%.0f tokens/s); host pad %.2f ms, '
            'dispatch %.2f ms, fetch (device wait, copy) %.2f ms'
            % (rows, sec * 1e3, rows * cfg.seq_len / sec, tm['pad_ms'],
               tm['dispatch_ms'], tm['fetch_ms']))

    log('(h) the NDArray path at full width')
    row_launches, nd_errs = nd_path(device, cfg, model)

    log('(i) mx.rtc on the card: user kernels compiled by NVRTC')
    rtc_engine_checks(device, cfg)
    rtc_launches, rtcs = rtc_path(device, cfg, model)
    rtc_errs = rtc_vs_plain(device, cfg, rtcs)

    log('(j) bench\'s training step at full width')
    step_launches, step_args = train_step(device, cfg)

    log('(k) bench\'s ResNet-50 step, the executor and autograd on the card')
    exec_launches, ag_launches, resnet = phase_k(device, cfg)

    log('(l) Module.fit, the kernels through Module and the Gluon loop')
    ckpt = os.path.join(work, 'resnet')
    module_launches, per_batch = phase_l(device, cfg, ckpt=ckpt)

    log('(m) the fused windows of Module.fit, score and predict')
    window_launches, windowed = phase_m(device, cfg, per_batch=per_batch)

    log('(n) the serving plane on the card')
    serve_flash, serve_rows = phase_n(device, cfg, model, ref, ckpt)

    log('(o) the op library and the zoo families on the card')
    op_launches = phase_o(device, cfg)

    log('(p) the training loop\'s telemetry and the profiler on the card')
    prof_launches, trace_ms = phase_p(device, cfg, work)

    log('(q) the data plane on the card')
    data_launches = phase_q(device, cfg, work, nd_figures={
        'per_batch': per_batch, 'window': windowed})

    log('(r) the RNN stack on the card')
    rnn_launches = phase_r(device)

    log('(s) the staged executor path on the card')
    staged_launches, custom_launches, _ = phase_s(device, cfg, work)

    log('(t) sparse storage and the contrib ops on the card')
    sparse_launches, contrib_launches, _ = phase_t(device, work)

    log('(u) the resilience tier on the card')
    resilience_launches, _ = phase_u(device, cfg, work)

    log('(e) times (median of CUDA-event runs)')
    t = times(device, model, ref, cfg)
    tt = train_times(device, cfg, *step_args)
    del step_args
    rt = row_times(device, cfg)
    for kernel, ms in trace_ms.items():
        log('  %s: %.4f ms a launch in (p2)\'s device trace at [8192, %d] '
            'f32, %.4f ms by CUDA events above at its (e) shape'
            % (kernel, ms, cfg.d_model if kernel == 'layernorm'
               else cfg.vocab, rt[kernel]['ms']))
    rtc_t = rtc_times(device, cfg, rtcs)
    log('(f) where the time goes: torch.profiler over 3 forwards at batch %d'
        % MAX_BATCH)
    profile_forward(device, model, cfg)
    log('(k) times of bench\'s ResNet-50 step')
    resnet_times(device, **resnet)
    del resnet
    log('  total %.1f s' % (time.perf_counter() - t_start))
    # the card again, so that a log cut at its head still names it
    log(card)

    record = {'kernels': [{
        'name': 'flash_attention', 'route': 'cuda',
        'source': 'mxnet_tpu_torch/ops/csrc/flash_attention.cu',
        'replaces': 'mxnet_tpu/ops/pallas_kernels.py:90',
        'body': 'wgmma', 'launches': launches,
        'train_step_launches': step_launches,
        'serving_launches': serve_flash,
        'staged_launches': staged_launches['flash_fwd'],
        'max_abs_err': errs[(SERVED_LAYOUT, True)],
        'ms': t['kernel_ms'], 'plain_ms': t['plain_ms'],
        'bound_ms': t['bound_ms'], 'bound_by': t['bound_by'],
        'library_ms': t['library_ms']}]}
    for kernel in ROW_KERNELS:
        record['kernels'].append({
            'name': kernel, 'route': 'cuda',
            'source': 'mxnet_tpu_torch/ops/csrc/row_kernels.cu',
            'replaces': ROW_REPLACES[kernel],
            'launches': row_launches[row_fns(kernel)[0].__name__],
            'executor_launches': exec_launches[row_fns(kernel)[0].__name__],
            'autograd_launches': ag_launches[row_fns(kernel)[0].__name__],
            'module_launches': module_launches[row_fns(kernel)[0].__name__],
            'window_launches': window_launches[row_fns(kernel)[0].__name__],
            'serving_launches': serve_rows[row_fns(kernel)[0].__name__],
            'op_library_launches': op_launches[row_fns(kernel)[0].__name__],
            'profiler_launches': prof_launches[row_fns(kernel)[0].__name__],
            'data_plane_launches': data_launches[row_fns(kernel)[0].__name__],
            'rnn_launches': rnn_launches[row_fns(kernel)[0].__name__],
            'staged_launches': staged_launches[row_fns(kernel)[0].__name__],
            'custom_launches': custom_launches[row_fns(kernel)[0].__name__],
            'sparse_launches': sparse_launches[row_fns(kernel)[0].__name__],
            'contrib_launches': contrib_launches[row_fns(kernel)[0].__name__],
            'resilience_launches':
                resilience_launches[row_fns(kernel)[0].__name__],
            'max_abs_err': nd_errs[kernel], **rt[kernel]})
    for name in rtc_kernels(cfg):
        record['kernels'].append({
            'name': name, 'route': 'cuda', 'source': 'chip_smoke.py',
            'replaces': RTC_REPLACES, 'launches': rtc_launches[name],
            'staged_launches': staged_launches['launch'],
            'max_abs_err': rtc_errs[name], **rtc_t[name]})
    log(json.dumps(record))
    # the run uses one card, whatever the machine holds
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': 1}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
