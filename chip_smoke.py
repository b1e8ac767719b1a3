#!/usr/bin/env python3
"""Quickest proof that the PyTorch port builds its kernels and trains on
one NVIDIA GPU. Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives ``oktopk_tpu_torch`` only (no JAX, nothing of ``oktopk_tpu``)
and prints one JSON line per phase:

1. build    — the four CUDA sources compiled by nvcc for sm_90a from
              ``oktopk_tpu_torch/csrc/`` (the fused select, the
              compaction, threefry, oktopk's combine), one nvcc per
              source, in parallel;
2. kernels  — the fused select kernel and the compaction kernel at the
              VGG-16 flat size n = 14,728,266, on seeded inputs in the
              fast, repair and wide regimes of the TPU kernels they
              replace, with R = 4 regions whose boundaries lie inside
              overflowing 1024-element blocks: each held bit-equal against
              its plain PyTorch version on the card. Then each kernel is
              timed in every form a path calls it in (K1's sweep; the
              compaction as oktopk's phase-(a) pack, R = 4, cap_pair, and
              phase-(b) select, R = 1, cap_exact, on an input nonzero in
              one quarter; as the whole-vector select of topkAopt and
              gaussiank, R = 1, cap_local; as topkSA's nonzero select,
              threshold 0, R = 1, cap_local, on a reduced row nonzero in one
              quarter; as topkSA's pack on the static equal split, R = 4,
              cap_pair), each form first held bit-equal to its plain
              version, with its plain version and the ``torch.nonzero``
              yardstick, two ways: ``ms``, CUDA events around one call
              (median of 25), and ``device_ms``, the device time of the
              call's own CUDA work under ``torch.profiler`` over 25 calls,
              divided by 25. A profiling window counts only if it shows
              every launch of the 25 calls: one compaction call is exactly
              two kernels;
3. edges    — the compaction kernel bit-equal to its plain version where
              its tiling can break (``compaction_cases``), on scratch
              poisoned with ready-looking status words, and in two
              back-to-back calls; then its pack timed in
              ``scripts/proto_repair_kernel.py``'s regime (``pack_proto``:
              n = 2^22, R = 4, cap 20,971) as the kernels phase times its
              forms;
4. allreduce — three oktopk steps at n = 2^20, P = 4 on the card against
              the plain path on the CPU from the same state: reduced
              result and residual bit-equal, thresholds within 64 ulps;
5. baselines_allreduce — the same for topkA, topkA2, topkAopt, gtopk,
              gaussiank, topkSA and gaussiankSA (cadence 2: recompute and
              predicted steps), and one topkSA step at density 1 that takes
              the dense fallback: results, residuals and counters
              bit-equal, thresholds within 8 ulps;
6. trainer  — VGG-16 at full width, P = 4 workers stacked on the card,
              global batch 64, density 0.02, one dense warmup step then
              five oktopk steps (local_recompute_every=1,
              global_recompute_every=4, threshold "bisect"), launch
              counters set to 0 just before and read just after;
7. baselines_trainer — the same model and batch through each of the
              seven baselines: one dense warmup step, then three sparse
              steps (local_recompute_every=2: recompute and predicted),
              counters set to 0 just before each run and read just after;
8. step_options — one more full-width oktopk run with two microbatches
              per worker, a gradient clip that binds, momentum correction
              and the ``eps_vs_dense`` metric;
37. obs_trainer — (after step_options) the run journal on the main path:
              ``main_trainer`` in this process, VGG-16 at full width, P =
              4, batch 16 a worker, d = 0.02, bf16 wire, 8 steps with
              ``--obs --obs-quality --obs-quality-every 4 --phase-timers
              --trace-at 5 --trace-steps 2 --log-every 4``, then the same
              8 steps without ``--obs``: the journal validates (one header
              naming the card), 8 ``step`` events with wire bytes, quality
              counts summing to 8 with a rollup each, one oktopk
              ``volume_report`` with a budget, ``rank0.log`` and
              ``scalars.csv`` written, the Chrome trace naming K1's and
              the compaction's kernels, both launched (``launches_by_path``
              ``vgg16 obs``); losses and volumes bit-identical with and
              without the journal; a regression detector on the run
              without it flags a planted 3x step (what it flags on the
              real steps is printed); step medians and spreads with and
              without, the flush's time, device memory, the card; its own
              budget, ``OBS_BUDGET_S``;
9. bert_kernels — (after ``edges``) the fused select kernel and the
              compaction's two oktopk forms at BERT-base's flat size n =
              110,106,428 and its k at d = 0.01, on rows of [4, n] buffers:
              bit-equal to their plain versions, then timed as above
              (``bert_sweep``, ``bert_pack_a``, ``bert_select_b``);
10. bert_parity — (after ``baselines_allreduce``) ``bert_tiny`` with
              dropout 0.1 from the same weights, batch (padded attention
              mask) and dropout key on the card and on the CPU: every
              site's mask bit-equal, logits, loss and the flat gradient in
              JAX leaf order within stated tolerances, then three oktopk
              steps (cadence 2) with finite, agreeing losses and equal
              volumes wherever the selections agree;
11. bert_trainer — (after step_options) the BERT slice at full width through
              ``main_bert.build_trainer``: BERT-base, P = 4 workers, bs 8
              each, seq 128, dropout 0.1, oktopk at d = 0.01 with the BERT
              cadences, BertAdam; five steps (the first the exact
              recompute and repartition), launch counters set to 0 just
              before and read just after; then ``_repartition`` at this
              size, its flattened scan against the row-wise one;
12. lstm_kernels — (after ``bert_kernels``) the same three forms at
              DeepSpeech's (``lstman4``) n = 54,791,168 and its k at
              d = 0.02 (``lstman4_sweep``, ``lstman4_pack_a``,
              ``lstman4_select_b``), bit-equal and timed as above;
13. lstman4_parity — (after ``bert_trainer``) ``lstman4_tiny`` from the
              same seed's weights on the card (cuDNN's RNN, CUDA CTC) and
              on the CPU, 201 frames, batch 4: logits, CTC loss and the
              flat gradient within 1e-4 of their largest; then whether
              the fwd/bwd, CTC's backward and the cuDNN LSTM backward
              each repeat bit for bit on the card;
14. lstman4_trainer — the LSTM slice at full width through
              ``main_trainer.build_trainer`` (``--dnn lstman4 --dataset
              an4``): 5 x 800, P = 4 stacked, bs 2 each, 201 frames,
              d = 0.02, ``--grad-clip 400``, bf16 wire; one dense warmup
              step, four oktopk steps, the split into fwd/bwd, collective
              and optimizer, peak memory, kernel calls per step; run
              twice from the same seed, with the verdict whether losses,
              volumes and parameters repeat bit for bit;
15. lstm_trainer — the PTB LSTM at full width (2 x 1500, vocabulary
              10,000, 35 tokens), P = 4 stacked, bs 20 each, dropout 0.65
              (JAX's masks, the threefry kernel; its three sites' masks
              card against CPU bit-equal), three oktopk steps;
16. dist_allreduce — one worker per process: every case of
              ``dist_cases`` (oktopk fused and unfused, each baseline,
              topkSA with a dense-fallback step; bf16 wire, n = 2^20) run
              by four gloo processes on the one card (NCCL refuses two
              ranks on one device), each a ``ProcessGroupComm`` rank,
              every rank's results and state bit-equal to the stacked
              comm's row on the card from the same seed; then one NCCL
              process at world size 1 against ``StackedComm(1)``;
17. dist_trainer — full-width VGG-16 through ``main_trainer.
              build_trainer`` as four gloo ranks on the card against the
              stacked Trainer from the same seed (one dense warmup step,
              three oktopk steps, global batch 64, cuDNN deterministic):
              losses and volumes equal, parameters and BatchNorm buffers
              bit-equal on every rank, launch counters of each rank read
              around its steps, the dense warmup's time per rank; then
              the ``torchrun`` CLI, four ranks of three steps, exit 0 with
              rank 0's log lines and its last loss and volume equal to
              dist_trainer's third step;
18. dist_bert — ``bert_tiny`` with dropout 0.1 through
              ``main_bert.build_trainer`` as four gloo ranks on the card,
              each deriving its own worker's keys, against the stacked
              Trainer: losses, volumes and every state_dict entry
              bit-equal on every rank. Spawned ranks are joined by a
              deadline and killed past it, and the CLI runs in its own
              session, killed whole on timeout: a rank that dies or hangs
              fails the run;
19. hier_kernels — (after ``lstm_kernels``) the compaction's two forms on
              the two-level path, where the outer oktopk runs at P =
              num_pods = 2, at VGG-16's n: ``hier_pack_a`` (R = 2, cap
              294,573, on K1's acc at ~2%) and ``hier_select_b`` (R = 1,
              cap 589,138, on a reduced row nonzero in one half), on row 1
              of [2, n] buffers, bit-equal and timed as above;
20. hier_allreduce — (after ``baselines_allreduce``) the two-level step
              over 2 pods x 2 stacked at n = 2^20, bf16 wire, with the
              dense, oktopk and topkA outers, three steps each, card
              against the CPU: results, residuals, counts and the four
              per-level wire fields bit-equal, thresholds within 64 ulps;
              one quality-tap step with the dense outer, comp_err <= 1e-10;
21. hierarchical — (after ``lstm_trainer``) the slice at full width:
              VGG-16's n through ``build_allreduce_step("hierarchical")``
              on 2 pods x 2 stacked, oktopk outer, one dense warmup step
              and five oktopk steps on seeded gradients, each bit-equal to
              flat oktopk over ``StackedComm(2)`` fed the pod means, every
              pod's member rows equal; step times (CUDA events), per-level
              conformance on the steady steps (<= 1), kernel calls per
              step (counters set to 0 just before each two-level step and
              read just after), peak memory, one quality-tap step;
22. dist_hierarchical — (after ``dist_allreduce``) the two-level step as
              four gloo processes on the card, 2 pods x 2 over
              ``dist.new_group`` groups, dense, oktopk and topkA outers,
              three steps each at n = 2^20: every rank bit-equal to the
              stacked two-level comm's row; per-rank step times.

23. threefry — (after ``edges``) ``csrc/threefry.cu``, the Bernoulli
              keep mask of JAX's dropout: Random123's known answers (the
              output words on the host; on the card the mask at each
              answer's counter pins the 23 bits it reads), the kernel
              bit-equal to its plain version at odd lengths and at
              counters past 2^32, one launch a mask; timed at BERT-base's
              attention-probability and hidden-state mask shapes
              (``threefry_attention``, ``threefry_hidden``);
24. resnet50_kernels — (after ``hier_kernels``) K1 and the compaction's
              two oktopk forms at ResNet-50's n = 25,557,032
              (``resnet50_sweep``, ``resnet50_pack_a``,
              ``resnet50_select_b``), bit-equal and timed as above;
25. zoo_parity — (after ``lstman4_parity``) every CNN of the zoo at full
              width (resnet20/56/110, resnet50, alexnet, densenet100,
              preresnet110, resnext29, caffe_cifar, mnistnet), two images,
              train mode: logits and the flat gradient on the card in
              float32 held to the CPU's float64 result as closely as the
              CPU's float32 is; ResNeXt-29's grouped fwd/bwd repeats bit
              for bit under deterministic cuDNN;
26. resnet50_trainer — (after ``lstm_trainer``) ``main_trainer --dnn
              resnet50 --dataset imagenet --batch-size 32 --num-workers 4
              --density 0.02`` (synthetic: no ImageNet file): one dense
              warmup step and four oktopk steps, twice from one seed, bit
              for bit; the split, kernel calls a step, peak memory, and
              one profiled step (device launches and time);
27. loader_cli — ``main_trainer`` on CIFAR-10 and MNIST files the script
              writes (resnet20, mnistnet; three steps each on the card,
              ``meta["synthetic"]`` False), then ``--dataset imagenet``
              without a file, which warns and trains on synthetic data.

Between resnet50_trainer and loader_cli, bfloat16 compute
(``--compute-dtype bfloat16``; their seconds in a ``bf16_seconds``
line):

34. bf16_parity — mnistnet, resnet20, bert_tiny, lstman4_tiny and
              lstm_tiny from one seed's weights (resnet20 and
              lstman4_tiny also on BatchNorm's running statistics): the
              card's bfloat16 logits and flat gradient against the CPU's
              bfloat16 within ``BF16_PARITY_FACTOR`` times the card's own
              distance from float32 (d_ref); the card again with cuBLAS
              allowed to reduce in bfloat16, its distance beside;
35. bf16_trainer — VGG-16, ResNet-50, BERT-base, DeepSpeech and the PTB
              LSTM at full width, P = 4 stacked, float32 then bfloat16
              in the same configuration (``BF16_CONFIGS``): the split of
              the steps, peak memory, finite losses (falling on a
              repeated batch but the PTB LSTM's), K1 and the compaction
              launched, one profiled step each (device launches and
              time); ResNet-50 in bfloat16 twice from one seed, bit for
              bit, its convolutions' TFLOP/s and the elementwise and
              reduction passes; BERT-base's fwd/bwd with cuBLAS's
              bfloat16 reduction allowed and not, in turns;
36. bf16_cli — ``main_trainer --dnn vgg16 --compute-dtype bfloat16``,
              three steps in its own process: exit 0, its last loss and
              volume equal to bf16_trainer's third VGG-16 step.

After loader_cli, the train surface, on files written into one temporary
directory (removed at the end; ``OKTOPK_STATE_DIR`` inside it,
``OKTOPK_NATIVE=1``, so a failing g++ build fails the run):

28. text_data — a corpus of 100 seeded documents and a 30,522-entry
              ``vocab.txt``; the native WordPiece tokenizer (g++ from
              ``native/``) equal to the Python one on every line and
              pair; the native prefetch ring and the Python batcher,
              each batch whole records and each epoch every record
              once; host ms a batch;
29. bert_ckpt — ``main_bert --model bert_base --data-dir T --num-workers
              4 --batch-size 8 --max-seq-length 128 --density 0.01
              --num-minibatches 4 --ckpt-dir D`` (the corpus, not
              synthetic data); the file verified by its manifest,
              restored into a fresh full-width Trainer on the card with
              every leaf bit-equal to the file, one step from it
              (counters around it); two ``--resume D`` runs of two more
              steps in new processes, their losses, volumes and final
              files bit-identical; bytes, save and restore seconds;
30. preempt — ``main_bert ... --handle-preemption --num-minibatches 50``
              in its own session, SIGUSR2 after its third logged step:
              exit 3 and the state parked at the step it stopped; the
              rerun resumes there, runs to step 50, exits 0 and clears
              the parked state; the session killed on a deadline;
31. glue_cli — ``glue --task mrpc --model bert_base --data-dir T/MRPC
              --vocab-file T/vocab.txt --ckpt D --epochs 1`` on TSVs the
              script writes: the grafted encoder bit-equal to the
              checkpoint's ``bert`` subtree; a finite loss, the metrics,
              exit 0 (counters around it);
32. an4_eval — ``main_trainer --dnn lstman4 --dataset an4`` on 16
              tone-coded WAV files and their manifests, four steps (one
              dense), ``--ckpt-every 4``; ``evaluate`` on the card and on
              the CPU: the CTC loss within 1e-4 relative (H18),
              hypotheses, WER and CER equal, or the differing count;
33. dist_ckpt — four gloo ranks of full-width VGG-16 through
              ``main_trainer.build_trainer``, four steps, a checkpoint
              (every rank's sparse row gathered to rank 0) whose state is
              the stacked Trainer's file bit for bit, and a four-rank
              restore giving each rank its row back; host time of the
              gather and of one stop poll (the ranks' agreement).
38. resilience — (after ``obs_trainer``) the numeric-health guard on
              the main path: full-width VGG-16 through
              ``main_trainer.build_trainer --resilience``, P = 4, global
              batch 64, d = 0.02, bf16 wire, two buckets, every recompute
              cadence 1 and no warmup (the CPU tests' cadences): a
              ``nan_grad`` on worker 1 at attempted step 2 skips that step
              alone, the parameters, SGD momentum and step, BatchNorm
              buffers and both buckets' residuals and thresholds
              bit-identical across it, the counters advanced, the losses
              bit-equal to a never-firing control's shifted by one
              (``launches_by_path`` ``vgg16 resilience``); a
              ``wire_bitflip`` from worker 2 on bucket 1 skips
              [0,1,1,1,0,0,0], three ``guard_trip`` then a ``fallback``,
              bucket 1 dense and bucket 0's kernels launched on; a
              ``scale_grad`` pressure then a clean streak journal a
              backoff then an advance, every residual kept across both
              re-plans; worker 3's chip lost at step 3 remeshes to three
              workers (global batch 48), the parameters bit-identical,
              ``health`` and ``supervisor`` carried; the CPU tests' plans
              on mnistnet card against CPU, the same decisions; the
              guarded step against the unguarded one in turns (host
              clock), and one profiled step of each (device ms,
              launches); its own budget, ``RES_BUDGET_S``;
39. vgg16_bucket_kernels — (after ``resnet50_kernels``) K1 and the
              compaction's two oktopk forms at VGG-16's two bucket sizes
              (``--num-buckets 2``, the resilience path): n = 7,379,978
              and 7,348,288 (``vgg16_b0_sweep``, ``vgg16_b0_pack_a``,
              ``vgg16_b0_select_b``, and ``vgg16_b1_*``), bit-equal and
              timed as above;
40. autotune — (after ``resilience``) the autotuner on the main path:
              full-width VGG-16 through ``main_trainer.build_trainer
              --autotune --autotune-candidates dense,oktopk
              --autotune-trial-steps 3 --obs``, P = 4, batch 16 a worker,
              d = 0.02, bf16 wire, two buckets, lr 0.01 (the journal's
              and the guard's phases' rate), then ``Trainer.train`` for
              6 steps, whose first runs the real calibrate -> trial ->
              policy pass: one ``calibration`` (measured, 4 probes, alpha
              and beta > 0), one ``autotune_decision`` per bucket choosing
              its fastest measured candidate, the step on the plan, K1 and
              the compaction's pack (R = 4) and select (R = 1) launched by
              the trials (``launches_by_path`` ``vgg16 autotune``), finite
              losses; every candidate's ms, the fit and the planned steps'
              host ms printed; a forced re-tune (``retune`` ->
              ``calibration`` -> ``autotune_decision``, re-planned only if
              the plan changed); mnistnet's fake seam, card = CPU, a mixed
              plan; the ``latency_retune`` drill (oktopk -> dense); the
              benchmark CLI (``python -m oktopk_tpu_torch.benchmarks.
              collectives``), its volumes the in-process step's; its own
              budget, ``AUTOTUNE_BUDGET_S``; and in ``dist_trainer`` four
              gloo ranks of VGG-16 ``--autotune`` over two buckets, every
              rank the same coefficients and plan;
41. anatomy — (after ``autotune``) the step anatomy on the main path
              (``obs/anatomy.py``, ``obs/tracing.py``): VGG-16 at full
              width, P = 4, batch 16 a worker, d = 0.02, bf16 wire, two
              buckets. (a) ``capture_pipeline_anatomy`` at the buckets'
              sizes (7,379,978 and 7,348,288): each phase's ms,
              ``overlap_ratio``, ``step_ms``, ``ideal_ms``; (b)
              ``main_trainer --obs --trace-at 3 --trace-steps 1``: the
              Chrome trace through ``analyze_capture``, buckets 0 and 1
              with select, stage, exchange and combine and fwd_bwd and
              optimizer on bucket -1, all on the stream
              (``gpu_user_annotation``), every kernel from the first
              fwd_bwd range to bucket 0 inside an ``anat/fwd_bwd`` range,
              K1 and the compaction launched (``launches_by_path``
              ``vgg16 anatomy``); (c) two trainers from one seed, the
              phase ranges on and off, six steps each in turns without a
              profiler and six inside one: losses bit-identical, host ms;
              one more profiled step each, without and with
              ``backward_scope``: how much of the fwd/bwd the ranges
              cover; (d) ``--resilience --obs --obs-trace-on-anomaly``
              with the resilience phase's NaN plan: exactly one
              ``trace_captured`` after the ``guard_trip``, its trace
              written (a profiler that cannot start fails the phase), with
              contract ranges on the stream; its own budget,
              ``ANATOMY_BUDGET_S``;
42. convergence — item 19 on the card: mnistnet on ``teacher_iterator``,
              dense then oktopk, ``tests/test_torch_convergence.py``'s
              settings (P = 8, batch 8 a worker, lr 0.05, d = 0.05, 80
              steps, no warmup): the mean loss of the last quarter of
              oktopk under 1.10 x dense's, both falling, K1 and the
              compaction launched (``mnistnet convergence``);
43. pipeline_kernels — (after ``vgg16_bucket_kernels``) K1 and the
              compaction's two oktopk forms at the pipeline's buckets of
              BERT-base at pp = 2, each reduced over a data group of dp =
              2 (R = 2 packs): a stage, n = 42,527,232
              (``bert_pp_stage_sweep``, ``_pack_a``, ``_select_b``), and
              the shared bucket, n = 25,051,964 (``bert_pp_shared_*``),
              bit-equal and timed as above;
44. pipeline — (after ``bert_trainer``) item 16a on the main path:
              ``main_bert --model bert_base --pipeline-stages 2
              --num-workers 4 --num-microbatches 4 --batch-size 8
              --compressor oktopk --density 0.01`` through its
              ``build_pipeline``: a data x pipe grid of 2 x 2 stacked on
              the card, five steps (the exact one, four steady), K1, the
              compaction and threefry launched (``launches_by_path``
              ``bert pipeline``), host ms a step, one profiled step
              (device busy ms), peak memory; the same with ``--remat``,
              losses, volumes and parameters bit-identical; two
              ``--compressor dense`` steps; one ``bert_tiny`` step card
              against CPU (loss within rtol 1e-5, thresholds within
              ``PIPE_TINY_ULPS``); its own budget, ``PIPELINE_BUDGET_S``;
45. dist_pipeline — (after ``dist_bert``) the pipeline as four gloo
              ranks on the card, pp = 2 x dp = 2 over ``dist.new_group``
              groups, ``bert_tiny`` with dropout 0.1, three oktopk steps:
              losses and volumes equal, and each rank's stage, shared
              parameters, BertAdam moments and sparse-state row bit-equal
              (sha1) to the stacked grid's;
46. seq_tp_kernels — (after ``pipeline_kernels``) K1 and the
              compaction's two oktopk forms over a data group of dp = 2
              (R = 2 packs) at the sequence-parallel bucket, BERT-base's
              whole gradient: n = 110,106,428 (``bert_seq_pack_a``,
              ``_select_b``; K1 is ``bert_sweep``'s shape) and, with 2,048
              position rows, 111,286,076 (``bert_seq_2048_*``); and at the
              tensor-parallel buckets at tp = 2: a shard, 42,499,584
              (``bert_tp_shard_*``), the shared copy, 25,107,260
              (``bert_tp_shared_*``); bit-equal and timed as above;
47. seq_parallel — (after ``pipeline``) item 16b-1 on the main path:
              ``main_bert --model bert_base --seq-shards 2
              --seq-data-shards 2 --batch-size 2 --compressor oktopk
              --density 0.01`` through its ``build_seq``: a data x seq
              grid of 2 x 2 stacked on the card, ring attention, three
              steps at T = 512 and three at T = 2048 (the exact step
              apart), K1 and the compaction launched, no threefry
              (``launches_by_path`` ``bert seq``), host ms a step, peak
              memory, the workers' copies bit-identical after every step;
              one fwd+bwd at T = 2048 at sp = 1 and sp = 4 (the stacked
              peak and its share a worker, the bytes autograd saves);
              ``bert_tiny`` card against CPU (losses within rtol 1e-5,
              thresholds within ``TINY_ULPS``), its oktopk through
              ``card_vs_cpu``; one ``--compute-dtype bfloat16`` step; its
              own budget, ``SEQ_BUDGET_S``;
48. tensor_parallel — item 16b-3: BERT-base over a data x model grid of
              2 x 2 stacked, ``build_tp_sparse_train_step`` with oktopk
              at d = 0.01 on each worker's tp shard and shared copy, 8 x
              128 a data row, three steps (``bert tp``): host ms, peak
              memory, launches, the shared copies bit-identical across
              model ranks and data rows after every step, the first loss
              against the single module's (rtol 1e-5); ``bert_tiny`` card
              against CPU; its own budget, ``TP_BUDGET_S``;
49. moe_kernels — (after ``seq_tp_kernels``) K1 and the compaction's two
              oktopk forms over a data group of dp = 2 (R = 2 packs) at
              the expert-parallel buckets of BERT-base with 4 experts over
              2 expert ranks: a worker's expert shard, 113,338,368
              (``bert_moe_shard_*``), and its shared copy, 53,474,108
              (``bert_moe_shared_*``); bit-equal and timed as above;
50. expert_parallel — (after ``tensor_parallel``) item 16b-2 on the main
              path: ``main_bert --model bert_base --expert-shards 2
              --expert-data-shards 2 --num-experts 4 --batch-size 8
              --compressor oktopk --density 0.01`` through its
              ``build_moe``: a data x expert grid of 2 x 2 stacked on the
              card, Switch top-1 MoE FFNs with the all_to_all dispatch,
              each worker's expert shard and shared copy through oktopk
              over its data group, BertAdam per expert: three steps (the
              exact one apart), counters set to 0 just before and read
              just after (K1 and the compaction launched, no threefry;
              ``launches_by_path`` ``bert moe``), host ms a step, peak
              memory, the shared copies bit-identical across every
              worker and each expert shard across the data rows after
              every step, the first step's routing (tokens dropped over
              capacity and each expert's load, per layer); the
              single-module oracle (identical experts, the zero gate,
              ``wo``/``bo`` x E, capacity factor E, no aux) within rtol
              1e-5 of the single module's loss at BERT-base width; one
              ``--compute-dtype bfloat16`` step; ``bert_tiny`` card
              against CPU (losses within rtol 1e-5, thresholds within
              ``TINY_ULPS``); its own budget, ``EXPERT_BUDGET_S``;
51. combine — (after ``threefry``) oktopk's combine kernels
              (``ops/combine.py``: ``cb_scatter``, ``cb_residual``) at
              BERT-base's n, VGG-16's n and its two bucket n's (7,379,978
              and 7,348,288), P = 4 stacked, d
              = 0.01, both wires, on ``combine_inputs`` (the compaction's
              real packs at each worker's lt, the comm's strided views):
              phase (a)'s and phase (b)'s scatters and the residual update
              each bit-equal to its plain version on the card, then timed
              as the kernels phase times its forms (``device_ms`` over 25
              calls, ``call_ms``), with the bound (bytes at 3.35 TB/s) and
              the plain version's times; one scatter call launches one
              ``cb_scatter`` per source row, the residual one
              ``cb_residual``.

Then the ``{"kernels": [...]}`` line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``. Any failure raises, prints
no result and exits non-zero, as does a machine without CUDA.
"""

from __future__ import annotations

import collections
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

N_VGG16 = 14728266
ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
SEED = 0
ITERS = 25


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def zero_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from oktopk_tpu_torch.ops import combine, compaction, fused_select, prng
    compaction.LAUNCHES = fused_select.LAUNCHES = prng.LAUNCHES = 0
    combine.LAUNCHES = 0


SPARSE_KERNELS = ("fused_select", "compaction")
DROPOUT_KERNELS = SPARSE_KERNELS + ("threefry",)


def assert_launched(launches: dict, kernels, where: str) -> None:
    """Raise unless each of ``kernels`` launched on the path just run."""
    for nm in kernels:
        if launches[nm] <= 0:
            raise AssertionError(f"{where}: the {nm} kernel never launched "
                                 "on the path")


def read_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel."""
    from oktopk_tpu_torch.ops import combine, compaction, fused_select, prng
    return {"fused_select": fused_select.LAUNCHES,
            "compaction": compaction.LAUNCHES, "threefry": prng.LAUNCHES,
            "combine": combine.LAUNCHES}


def cuda_time_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
    """Median of ``iters`` single-call CUDA-event timings."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def profile_window(fn, iters: int):
    """({activity name: launches}, {activity name: device ms per call})
    of ``iters`` calls under ``torch.profiler``: every kernel, copy and
    fill the calls put on the card, by self device time. The phase ranges'
    spans on the stream (``obs/anatomy.py``'s ``anat/...``) are not device
    work of their own and are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from oktopk_tpu_torch.obs.anatomy import parse_scope_level
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    counts, by_op = {}, {}
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or parse_scope_level(e.key) is not None):
            continue
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0)
        name = e.key.split("(")[0][:60]
        counts[name] = counts.get(name, 0) + e.count
        by_op[name] = by_op.get(name, 0.0) + dt / 1e3 / iters
    return counts, by_op


def device_time(fn, expect=None, iters: int = ITERS, warmup: int = 3):
    """(device ms per call, device launches per call, ms per call by
    activity name) from a profiling window that shows every launch of the
    ``iters`` calls. A window now and then comes back without some of its
    device events, which would flatter the time, so a window counts only
    if it shows exactly ``expect`` ({kernel name: launches per call}) or,
    without ``expect``, the same launches as the window before it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    want = None if expect is None else {k: v * iters
                                        for k, v in expect.items()}
    seen = []
    for _ in range(5):
        counts, by_op = profile_window(fn, iters)
        if counts == (want if want is not None else
                      (seen[-1] if seen else None)):
            return (sum(by_op.values()), sum(counts.values()) / iters,
                    by_op)
        seen.append(counts)
    raise AssertionError(f"no profiling window showed the launches of "
                         f"{iters} calls (expected {want}): {seen}")


def timing(fn, expect=None) -> dict:
    ms, per_call, by_op = device_time(fn, expect)
    return {"device_ms": ms, "call_ms": cuda_time_ms(fn),
            "launches_per_call": per_call, "device_ops": by_op}


def bits_equal(a, b, what: str) -> float:
    """Raise unless ``a`` and ``b`` are bit-identical; returns the largest
    absolute difference (0.0 when they are)."""
    import torch
    a, b = a.detach(), b.detach()
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{what}: {tuple(a.shape)}/{a.dtype} vs "
                             f"{tuple(b.shape)}/{b.dtype}")
    err = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    bad = int((a != b).sum())
    if bad:
        raise AssertionError(f"{what}: {bad} elements differ "
                             f"(max abs err {err})")
    return err


def triples_equal(got, want, what: str) -> float:
    """``bits_equal`` over (values, indices, counts)."""
    return max(bits_equal(a, b, f"{what} {f}") for f, a, b in
               zip(("values", "indices", "counts"), got, want))


def max_ulps(a, b) -> int:
    import torch
    ai = a.detach().float().cpu().view(torch.int32).long()
    bi = b.detach().float().cpu().view(torch.int32).long()
    return int((ai - bi).abs().max())


def make_regimes(n: int, dev, straddle_blocks):
    """(name, grad, residual, threshold) at ~2% density: no 1024-element
    block over 128 survivors (fast); 1..nb/8 such blocks (the TPU's repair
    regime); more than nb/8 (its wide regime). ``straddle_blocks`` (the
    blocks holding region boundaries) overflow in both of the latter."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED)
    nb = -(-n // 1024)
    base = torch.randn(n, generator=gen, device=dev)
    res = 0.05 * torch.randn(n, generator=gen, device=dev)
    t = 2.33
    out = [("fast", base, res, t)]
    for name, nblk in (("repair", nb // 16), ("wide", nb // 4)):
        g = base.clone()
        blocks = torch.randperm(nb - 1, generator=gen, device=dev)[:nblk]
        blocks = torch.unique(torch.cat([blocks, torch.tensor(
            straddle_blocks, dtype=blocks.dtype, device=dev)]))
        idx = (blocks[:, None] * 1024
               + torch.arange(1024, device=dev)[None, :]).reshape(-1)
        g[idx] = g[idx] * 4.0
        out.append((name, g, res, t))
    return out


def block_overflow(x, t, n):
    import torch
    nb = -(-n // 1024)
    m = torch.nn.functional.pad((x.abs() >= t).int(), (0, nb * 1024 - n))
    raw = m.view(nb, 1024).sum(1)
    return int((raw > 128).sum()), nb


def compaction_cases():
    """Inputs where the compaction kernel's tiling can break, made with
    numpy from SEED: dicts of name, x (f32 [n]), t, bounds ([R+1] or
    None), cap, and offset (elements before x in its buffer on the card,
    whose start is 16-byte aligned)."""
    import numpy as np
    from oktopk_tpu_torch.ops import compaction
    T = compaction.TILE
    rng = np.random.RandomState(SEED)
    cases = []

    def add(name, x, t, bounds, cap, offset=0):
        cases.append({"name": name, "x": np.asarray(x, np.float32),
                      "t": t, "bounds": bounds, "cap": cap,
                      "offset": offset})

    def randn(n):
        return rng.randn(n).astype(np.float32)

    add("n=1", [3.0], 1.0, [0, 0, 1], 1)
    n = 1000                             # below one tile
    add("n below a tile, empty first and last regions", randn(n), 1.0,
        [0, 0, 10, n, n], 64)
    n = 3 * T + 1                        # neither a multiple of T nor of 4
    add("ragged n, boundaries on tile edges, two in one tile", randn(n), 2.0,
        [0, T, T + 4, T + 100, 2 * T, n], 1024)
    n = 2 * T + 6                        # n = 2 mod 4
    add("row 1 of a [2, n] buffer: 8 bytes off 16", randn(n), 1.5,
        [0, T - 2, T - 1, 2 * T - 2, n], 512, offset=n)
    for off in (1, 3):
        add(f"x {4 * off} bytes off 16, boundary on the shifted tile edge",
            randn(n), 1.5, [0, T - off, T - off, n - 1, n], 512, offset=off)
    n = 5 * T + 3
    x = randn(n)
    add("cap=1, survivors past cap", x, 0.5, [0, 100, 3 * T, 3 * T + 1, n],
        1)
    add("NaN threshold", x, float("nan"), [0, T, 2 * T, 3 * T, n], 256)
    add("all-zero x", np.zeros(n), 0.0, [0, 0, T, n, n], 256)
    xs = np.zeros(n, np.float32)
    xs[::97] = 1.5
    xs[5::211] = np.float32(1e-40)       # subnormal: below the clamp
    add("zero threshold: nonzeros only, subnormals out", xs, 0.0,
        [0, 1, 2 * T + 1, 4 * T, n], 512)
    # the TPU kernels' three regimes, boundaries inside overflowing blocks
    n = 64 * 1024 + 333
    bnd = [0, 3 * 1024 + 500, 17 * 1024 + 7, 40 * 1024 + 1000, n]
    add("fast regime", randn(n), 2.0, bnd, 8 * 1024)
    x = 0.1 * randn(n)
    for b in (3, 17, 40):
        x[b * 1024:(b + 1) * 1024] = rng.randn(1024) * 10 + 20
    add("repair regime", x, 1.0, bnd, 8 * 1024)
    add("wide regime", randn(n) + 3.0, 0.5, bnd, 8 * 1024)
    # scripts/proto_repair_kernel.py's regime: Student-t(3), 5% of the
    # 1024-blocks x50, t the k-th largest |x| at d = 0.02
    n = 1 << 22
    prng = np.random.RandomState(0)
    x = prng.standard_t(3, size=n).astype(np.float32)
    hot = prng.choice(n // 1024, size=n // 1024 // 20, replace=False)
    x.reshape(-1, 1024)[hot] *= 50.0
    k = int(n * 0.02)
    add("prototype regime", x, float(np.sort(np.abs(x))[-k]),
        [0, n // 4, n // 2, 3 * n // 4, n], k // 4)
    return cases


def check_compaction_case(case, dev) -> float:
    """The kernel (select over all of x; pack over the case's regions)
    against its plain version on the card, bit for bit."""
    import torch
    from oktopk_tpu_torch.ops import compaction
    xn, off, cap = case["x"], case["offset"], case["cap"]
    buf = torch.zeros(off + xn.size, dtype=torch.float32, device=dev)
    x = buf[off:]
    x.copy_(torch.from_numpy(xn))
    shift = compaction.tile_geometry(xn.size, x.data_ptr())[0]
    if shift != off % 4:
        raise AssertionError(f"{case['name']}: x sits {shift} elements off "
                             f"16 bytes, expected {off % 4}")
    t = torch.tensor(case["t"], dtype=torch.float32, device=dev)
    name = case["name"]
    err = triples_equal(compaction.select_by_threshold(x, t, cap),
                        compaction.select_by_threshold_plain(x, t, cap),
                        f"{name}: select")
    if case["bounds"] is not None:
        bnd = torch.tensor(case["bounds"], dtype=torch.int32, device=dev)
        R = len(case["bounds"]) - 1
        err = max(err, triples_equal(
            compaction.pack_by_region(x, t, bnd, R, cap),
            compaction.pack_by_region_plain(x, t, bnd, R, cap),
            f"{name}: pack"))
    return err


def phase_build():
    from oktopk_tpu_torch.ops import _build
    secs = _build.build_all()
    for nm in _build.SOURCES:
        _build.library(nm)
    ptxas = {nm: [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln]
             for nm, log in _build.build_logs.items()}
    emit({"phase": "build", "seconds": secs, "arch": "sm_90a",
          "sources": sorted(_build.SOURCES.values()), "ptxas": ptxas})


def phase_b_input(n: int, cap: int, dev, parts: int = 4):
    """A reduced row as phase (b) selects from it with ``parts`` owners:
    nonzero in one part only (the second), thresholded at its cap-th
    largest magnitude."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.zeros(n, dtype=torch.float32, device=dev)
    q = n // parts
    x[q:2 * q] = torch.randn(q, generator=gen, device=dev)
    t = torch.topk(x[q:2 * q].abs(), cap).values[-1].reshape(())
    return x, t


def reduced_row(n: int, dev):
    """A row as topkSA's owner holds it after phase (a) with P = 4: the
    summed selections of four workers, nonzero (about 8%) in its own
    quarter only, with subnormals there that the min-normal clamp must
    leave out."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = torch.zeros(n, dtype=torch.float32, device=dev)
    q = n // 4
    z = torch.randn(q, generator=gen, device=dev)
    x[q:2 * q] = torch.where(z.abs() >= 1.75, z, torch.zeros_like(z))
    x[q + 5:2 * q:4099] = 1e-40
    return x


def library_call(x, t):
    """The yardstick: torch.nonzero of the mask plus a gather (never called
    by the port)."""
    import torch
    idx = torch.nonzero(x.abs() >= t).squeeze(1)
    return x[idx], idx


def region_bounds(n: int, dev):
    """R = 4 region boundaries off the 1024-element block grid; the blocks
    holding them overflow in the repair and wide inputs."""
    import torch
    return torch.tensor([0, n // 4 + 517, n // 2 + 3, 3 * n // 4 + 1023, n],
                        dtype=torch.int32, device=dev)


# the kernels one call of each wrapper launches, and how often
K1_LAUNCHES = {"fs_zero": 1, "fs_sweep": 1}
COMPACTION_LAUNCHES = {"cp_prefill": 1, "cp_compact": 1}


def phase_kernels(dev):
    import torch
    from oktopk_tpu_torch.collectives.state import equal_boundaries
    from oktopk_tpu_torch.config import OkTopkConfig
    from oktopk_tpu_torch.ops import compaction, fused_select

    n, P = N_VGG16, 4
    cfg = OkTopkConfig(n=n, num_workers=P, density=0.02)
    cap = cfg.cap_pair
    bnd = region_bounds(n, dev)
    regimes = make_regimes(n, dev, [int(b) // 1024 for b in bnd[1:-1]])
    errs = {"fused_select": 0.0, "compaction": 0.0}
    fast = None
    for name, g, r, t in regimes:
        tt = torch.full((), t, dtype=torch.float32, device=dev)
        tp = tt * 1.25
        st = fused_select.fused_select_stage(g, r, tt, tp)
        ref = fused_select.fused_select_plain(g, r, tt, tp)
        for f in ("acc", "local_count", "probe_count", "hist"):
            errs["fused_select"] = max(errs["fused_select"], bits_equal(
                getattr(st, f), getattr(ref, f), f"{name}: {f}"))
        novf, nb = block_overflow(st.acc, t, n)
        got = fused_select.fused_pack_finalize(st, bnd, P, cap)
        want = compaction.pack_by_region_plain(st.acc, tt, bnd, P, cap)
        errs["compaction"] = max(
            errs["compaction"], triples_equal(got, want, f"{name}: pack"),
            triples_equal(
                compaction.select_by_threshold(st.acc, tt, cfg.cap_gather),
                compaction.select_by_threshold_plain(st.acc, tt,
                                                     cfg.cap_gather),
                f"{name}: select"))
        torch.cuda.synchronize()
        emit({"phase": "kernels", "regime": name, "n": n,
              "overflowing_blocks": novf, "blocks": nb,
              "local_count": int(st.local_count),
              "counts": [int(c) for c in got[2].reshape(-1)],
              "bit_equal": True})
        if name == "fast":
            fast = (g, r, tt, tp, st)

    g, r, tt, tp, st = fast
    acc = st.acc
    xb, tb = phase_b_input(n, cfg.cap_exact, dev)
    xr = reduced_row(n, dev)
    static = equal_boundaries(n, P, dev)
    min_normal = torch.tensor(compaction.MIN_NORMAL, device=dev)
    zero = torch.zeros((), device=dev)
    forms = {
        "fused_select": {
            "kernel": lambda: fused_select.fused_select_stage(g, r, tt, tp),
            "plain": lambda: fused_select.fused_select_plain(g, r, tt, tp),
            "expect": K1_LAUNCHES,
            "bound_ms": (12 * n + 8 + 4 * 258) / HBM_BYTES_PER_S * 1e3},
        "pack_a": {
            "R": P, "cap": cap,
            "kernel": lambda: fused_select.fused_pack_finalize(st, bnd, P,
                                                               cap),
            "plain": lambda: compaction.pack_by_region_plain(acc, tt, bnd, P,
                                                             cap),
            "library": lambda: library_call(acc, tt),
            "expect": COMPACTION_LAUNCHES,
            "bound_ms": compaction_bound_ms(n, P, cap, True)},
        "select_b": {
            "R": 1, "cap": cfg.cap_exact,
            "kernel": lambda: compaction.select_by_threshold(
                xb, tb, cfg.cap_exact),
            "plain": lambda: compaction.select_by_threshold_plain(
                xb, tb, cfg.cap_exact),
            "library": lambda: library_call(xb, tb),
            "expect": COMPACTION_LAUNCHES,
            "bound_ms": compaction_bound_ms(n, 1, cfg.cap_exact, False)},
        "select_local": {
            "R": 1, "cap": cfg.cap_local,
            "kernel": lambda: compaction.select_by_threshold(
                acc, tt, cfg.cap_local),
            "plain": lambda: compaction.select_by_threshold_plain(
                acc, tt, cfg.cap_local),
            "library": lambda: library_call(acc, tt),
            "expect": COMPACTION_LAUNCHES,
            "bound_ms": compaction_bound_ms(n, 1, cfg.cap_local, False)},
        # timed at a threshold of 0 made once: ``select_nonzero`` itself
        # adds one 0-d fill launch per call (held bit-equal below)
        "select_nonzero": {
            "R": 1, "cap": cfg.cap_local,
            "kernel": lambda: compaction.select_by_threshold(
                xr, zero, cfg.cap_local),
            "plain": lambda: compaction.select_nonzero_plain(
                xr, cfg.cap_local),
            "library": lambda: library_call(xr, min_normal),
            "expect": COMPACTION_LAUNCHES,
            "bound_ms": compaction_bound_ms(n, 1, cfg.cap_local, False)},
        "pack_static": {
            "R": P, "cap": cap,
            "kernel": lambda: compaction.pack_by_region(acc, tt, static, P,
                                                        cap),
            "plain": lambda: compaction.pack_by_region_plain(
                acc, tt, static, P, cap),
            "library": lambda: library_call(acc, tt),
            "expect": COMPACTION_LAUNCHES,
            "bound_ms": compaction_bound_ms(n, P, cap, True)},
    }
    for nm in ("select_b", "select_local", "select_nonzero", "pack_static"):
        errs["compaction"] = max(errs["compaction"], triples_equal(
            forms[nm]["kernel"](), forms[nm]["plain"](), nm))
    errs["compaction"] = max(errs["compaction"], triples_equal(
        compaction.select_nonzero(xr, cfg.cap_local),
        compaction.select_nonzero_plain(xr, cfg.cap_local),
        "select_nonzero wrapper"))
    timings = {}
    for nm, f in forms.items():
        rec = {k: v for k, v in f.items()
               if k in ("R", "cap", "bound_ms")}
        rec["kernel"] = timing(f["kernel"], f["expect"])
        for which in ("plain", "library"):
            if which in f:
                rec[which] = timing(f[which])
        if nm != "fused_select" and rec["kernel"]["launches_per_call"] != 2:
            raise AssertionError(f"{nm}: {rec['kernel']['launches_per_call']}"
                                 " device launches per compaction call")
        timings[nm] = rec
        emit({"phase": "kernel_times", "form": nm, **rec})
    return timings, errs


def compaction_bound_ms(n: int, R: int, cap: int, bounds: bool) -> float:
    """Bytes over HBM rate: x and the threshold (and the R+1 boundaries)
    read once; values, indices [R, cap] and counts [R] written once."""
    read = 4 * n + 4 + (4 * (R + 1) if bounds else 0)
    return (read + 8 * R * cap + 4 * R) / HBM_BYTES_PER_S * 1e3


def check_scratch_reset(dev) -> float:
    """The C entry point resets its scratch: a call on scratch whose words
    already look published (flag 2, a wrong value), and two back-to-back
    calls without a sync between (the second gets the first's freed
    scratch from the caching allocator), each bit-equal to the plain
    version."""
    import torch
    from oktopk_tpu_torch.ops import _build, compaction
    n, R, cap = 3 * compaction.TILE + 77, 3, 700
    x = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(
        SEED + 2), device=dev)
    t = torch.tensor(1.5, device=dev)
    bnd = torch.tensor([0, 4000, 4100, n], dtype=torch.int32, device=dev)
    words = compaction.scratch_words(n, x.data_ptr(), R)
    scratch = torch.full((words,), (2 << 32) | 12345, dtype=torch.int64,
                         device=dev)
    out = [torch.full((R, cap), 7.0, device=dev),
           torch.full((R, cap), -1, dtype=torch.int32, device=dev),
           torch.full((R,), -1, dtype=torch.int32, device=dev)]
    _build.check(_build.library("compaction").oktopk_compact(
        x.data_ptr(), n, t.data_ptr(), bnd.data_ptr(), R, cap,
        scratch.data_ptr(), words, *(o.data_ptr() for o in out),
        _build.stream_handle(dev)), "compaction kernel")
    want = compaction.pack_by_region_plain(x, t, bnd, R, cap)
    err = triples_equal(out, want, "poisoned scratch")
    y = -0.5 * x.flip(0)
    first = compaction.pack_by_region(x, t, bnd, R, cap)
    second = compaction.pack_by_region(y, t, bnd, R, cap)
    return max(err, triples_equal(first, want, "back-to-back 1"),
               triples_equal(second, compaction.pack_by_region_plain(
                   y, t, bnd, R, cap), "back-to-back 2"))


def proto_timing(case, dev) -> dict:
    """The compaction's pack in ``scripts/proto_repair_kernel.py``'s
    regime (the case checked bit-equal above), timed as the kernels
    phase times its forms: the kernel, its plain version and the
    ``torch.nonzero`` yardstick, and the bound."""
    import torch
    from oktopk_tpu_torch.ops import compaction
    x = torch.from_numpy(case["x"]).to(dev)
    t = torch.tensor(case["t"], dtype=torch.float32, device=dev)
    bnd = torch.tensor(case["bounds"], dtype=torch.int32, device=dev)
    R, cap, n = len(case["bounds"]) - 1, case["cap"], case["x"].size
    rec = {"R": R, "cap": cap, "n": n,
           "bound_ms": compaction_bound_ms(n, R, cap, True),
           "kernel": timing(lambda: compaction.pack_by_region(
               x, t, bnd, R, cap), COMPACTION_LAUNCHES),
           "plain": timing(lambda: compaction.pack_by_region_plain(
               x, t, bnd, R, cap)),
           "library": timing(lambda: library_call(x, t))}
    emit({"phase": "kernel_times", "form": "pack_proto", **rec})
    return rec


def phase_edges(dev):
    import torch
    cases = compaction_cases()
    err = max(check_compaction_case(case, dev) for case in cases)
    err = max(err, check_scratch_reset(dev))
    torch.cuda.synchronize()
    emit({"phase": "edges", "cases": [c["name"] for c in cases]
          + ["poisoned scratch", "back-to-back calls"],
          "bit_equal": True, "max_abs_err": err})
    return err, proto_timing(next(c for c in cases
                                  if c["name"] == "prototype regime"), dev)


# the state fields a card-vs-CPU comparison holds bit-equal
EXACT_FIELDS = ("residual", "boundaries", "last_volume", "wire_bytes",
                "last_wire_bytes", "wire_bytes_intra",
                "last_wire_bytes_intra", "wire_bytes_inter",
                "last_wire_bytes_inter", "last_local_count",
                "last_global_count", "step")


def card_vs_cpu(name: str, cfg, steps: int, dev, ulps_limit: int):
    """``steps`` steps of ``name`` at ``cfg`` (a ``HierarchicalConfig``
    for ``hierarchical``, over the two-level stacked comm): the card from
    the state the CPU (plain versions) reached, compared step by step.
    Results, residuals, boundaries, counters and the per-level wire
    fields bit-equal; thresholds within ``ulps_limit``. Returns the
    largest threshold distance in ulps and the last state."""
    import numpy as np
    import torch
    from oktopk_tpu_torch.collectives.api import (batched_init_state,
                                                  build_allreduce_step)
    from oktopk_tpu_torch.collectives.state import SparseState

    P, n = cfg.num_workers, cfg.n
    step = build_allreduce_step(name, cfg, warmup=False)
    rng = np.random.RandomState(SEED)
    base = rng.randn(P, n).astype(np.float32)
    state = batched_init_state(cfg, "cpu")
    worst = 0
    for i in range(steps):
        g = base + 0.3 * rng.randn(P, n).astype(np.float32)
        gs = SparseState.from_numpy(state.to_numpy(), dev)
        out_c, state2 = step(torch.from_numpy(g), state)
        out_g, gs2 = step(torch.from_numpy(g).to(dev), gs)
        what = f"{name} step {i}"
        bits_equal(out_g.cpu(), out_c, f"{what}: result")
        a, b = gs2.to_numpy(), state2.to_numpy()
        for f in EXACT_FIELDS:
            bits_equal(torch.from_numpy(a[f]), torch.from_numpy(b[f]),
                       f"{what}: {f}")
        for f in ("local_threshold", "global_threshold", "drift",
                  "last_exact_lt"):
            u = max_ulps(torch.from_numpy(a[f]), torch.from_numpy(b[f]))
            worst = max(worst, u)
            if u > ulps_limit:
                raise AssertionError(f"{what}: {f} {u} ulps")
        state = state2
    return worst, state


def phase_allreduce(dev):
    """Three oktopk steps at n = 2^20, P = 4: the card (both kernels) from
    the state the CPU (plain versions) reached, compared step by step."""
    from oktopk_tpu_torch.config import OkTopkConfig

    P, n = 4, 1 << 20
    cfg = OkTopkConfig(n=n, num_workers=P, density=0.02, warmup_steps=0,
                       local_recompute_every=2, global_recompute_every=2,
                       repartition_every=3, threshold_method="hist")
    worst, _ = card_vs_cpu("oktopk", cfg, 3, dev, 64)
    emit({"phase": "allreduce", "n": n, "P": P, "steps": 3,
          "result_bit_equal": True, "threshold_max_ulps": worst})


BASELINES = ("topkA", "topkA2", "topkAopt", "gtopk", "gaussiank", "topkSA",
             "gaussiankSA")
# the baselines that select through the compaction kernel
COMPACTING = ("topkAopt", "gaussiank", "topkSA", "gaussiankSA")


def phase_baselines_allreduce(dev):
    """Each baseline, three steps at n = 2^20, P = 4 (cadence 2: recompute,
    predicted, recompute) on the card against the CPU; thresholds by the
    exact top-k ("sort", bit-reproducible on both); then one topkSA step
    at density 1, where the reduced result is dense and the psum fallback
    is taken."""
    from oktopk_tpu_torch.config import OkTopkConfig

    P, n = 4, 1 << 20
    cfg = OkTopkConfig(n=n, num_workers=P, density=0.02, warmup_steps=0,
                       local_recompute_every=2, threshold_method="sort")
    ulps = {nm: card_vs_cpu(nm, cfg, 3, dev, 8)[0] for nm in BASELINES}
    u, st = card_vs_cpu("topkSA", cfg.replace(density=1.0), 1, dev, 8)
    if float(st.last_volume[0]) < 2.0 * n:
        raise AssertionError("topkSA at density 1 did not take the dense "
                             "fallback")
    ulps["topkSA dense fallback"] = u
    emit({"phase": "baselines_allreduce", "n": n, "P": P, "steps": 3,
          "result_bit_equal": True, "threshold_max_ulps": ulps})


HIER_PODS, HIER_POD_SIZE = 2, 2
HIER_OUTERS = ("dense", "oktopk", "topkA")


def hier_config(outer: str, n: int, **kw):
    """The two-level config of 2 pods x 2 workers over ``outer``, bf16
    wire, d = 0.02; ``kw`` overrides the flat config's cadences."""
    from oktopk_tpu_torch.collectives.hierarchical import \
        make_hierarchical_config
    from oktopk_tpu_torch.config import OkTopkConfig
    flat = OkTopkConfig(**{**dict(
        n=n, num_workers=HIER_PODS * HIER_POD_SIZE, density=0.02,
        warmup_steps=0, local_recompute_every=2, global_recompute_every=2,
        repartition_every=3, threshold_method="hist",
        wire_dtype="bfloat16"), **kw})
    return make_hierarchical_config(flat, num_pods=HIER_PODS, outer=outer)


def quality_row(qbuf) -> dict:
    """The ring's newest row (worker rows averaged), by column."""
    from oktopk_tpu_torch.obs.metrics_buffer import COLUMNS, rows_since
    q = qbuf.to_numpy()
    cur = int(q["cursor"][0])
    return dict(zip(COLUMNS, (float(v) for v in
                              rows_since(q["ring"], cur, cur - 1)[-1])))


def tapped_step(hcfg, grads, state, dev) -> dict:
    """One ``build_quality_allreduce_step`` step of ``hcfg`` on the card
    from ``state`` and a fresh ring: the row it pushed."""
    from oktopk_tpu_torch.collectives.api import build_quality_allreduce_step
    from oktopk_tpu_torch.obs.metrics_buffer import init_buffer
    from oktopk_tpu_torch.obs.quality import QualityConfig
    q = QualityConfig(every=4, sig_bins=512)
    step = build_quality_allreduce_step("hierarchical", hcfg, quality=q,
                                        warmup=False)
    _, _, qbuf = step(grads, state, init_buffer(q.every, q.sig_bins,
                                                hcfg.num_workers, dev))
    row = quality_row(qbuf)
    if not all(math.isfinite(v) for v in row.values()):
        raise AssertionError(f"quality tap: non-finite column {row}")
    return row


def phase_hier_allreduce(dev):
    """The two-level step over 2 pods x 2 stacked at n = 2^20, bf16 wire,
    with the dense, oktopk and topkA outers, three steps each (oktopk's
    first exact): the card from the state the CPU reached, results,
    residuals, counts and the four per-level wire fields bit-equal,
    thresholds within 64 ulps; then one quality-tap step with the dense
    outer, whose comp_err must be at most 1e-10."""
    import torch
    from oktopk_tpu_torch.collectives.api import batched_init_state

    n = 1 << 20
    ulps = {o: card_vs_cpu("hierarchical", hier_config(o, n), 3, dev, 64)[0]
            for o in HIER_OUTERS}
    h = hier_config("dense", n)
    g = torch.randn((h.num_workers, n), generator=torch.Generator(
        device=dev).manual_seed(SEED + 7), device=dev)
    row = tapped_step(h, g, batched_init_state(h, dev), dev)
    if not row["comp_err"] <= 1e-10:
        raise AssertionError(f"dense outer: comp_err {row['comp_err']}")
    emit({"phase": "hier_allreduce", "n": n, "pods": HIER_PODS,
          "pod_size": HIER_POD_SIZE, "steps": 3, "result_bit_equal": True,
          "threshold_max_ulps": ulps, "dense_outer_quality": row})


def phase_hierarchical(dev, oktopk_steps: int = 5):
    """The slice at full width: VGG-16's n through
    ``build_allreduce_step("hierarchical", ...)`` on 2 pods x 2 stacked,
    oktopk outer (cadences 1/4, bf16 wire, d = 0.02), one dense warmup
    step then ``oktopk_steps`` steps on seeded gradients. Each step is
    held bit-equal on the card to flat oktopk over ``StackedComm(2)`` fed
    the pod means (the composition identity), and every pod's member rows
    of results and state equal; per-level conformance on the steady steps
    (the exact recomputes left out) must be at most 1. Launch counters are
    set to 0 just before each two-level step and read just after (the flat
    comparison's launches are not counted). Then one quality-tap step.
    Returns the path's launches."""
    import torch
    from oktopk_tpu_torch.collectives.api import (batched_init_state,
                                                  build_allreduce_step)
    from oktopk_tpu_torch.collectives.state import TENSOR_FIELDS
    from oktopk_tpu_torch.comm import StackedComm, hierarchical_comm
    from oktopk_tpu_torch.obs.volume import (hierarchical_budget_bytes,
                                             hierarchical_volume_report)

    h = hier_config("oktopk", N_VGG16, warmup_steps=1,
                    local_recompute_every=1, global_recompute_every=4,
                    repartition_every=64, threshold_method="bisect")
    W, n, pod = h.num_workers, h.n, h.pod_size
    hstep = build_allreduce_step("hierarchical", h,
                                 hierarchical_comm(h.num_pods, pod))
    fstep = build_allreduce_step("oktopk", h.outer_cfg,
                                 StackedComm(h.num_pods))
    hs = batched_init_state(h, dev)
    fs = batched_init_state(h.outer_cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    base = torch.randn((W, n), generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    launches = dict.fromkeys(read_counts(), 0)
    recs, intra, inter = [], [], []
    for s in range(1 + oktopk_steps):
        g = base + 0.3 * torch.randn((W, n), generator=gen, device=dev)
        ocfg = h.outer_cfg
        dense = s < ocfg.warmup_steps
        exact = not dense and (s == ocfg.warmup_steps
                               or s % ocfg.global_recompute_every == 0)
        torch.cuda.synchronize()
        zero_counts()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out, hs = hstep(g, hs)
        b.record()
        b.synchronize()
        calls = read_counts()
        for k, v in calls.items():
            launches[k] += v
        # the flat outer fed the pod means, members added in order
        pm = g.view(h.num_pods, pod, n)
        acc = pm[:, 0].clone()
        for m in range(1, pod):
            acc = acc + pm[:, m]
        fout, fs = fstep(acc / pod, fs)
        for p in range(h.num_pods):
            rows = slice(p * pod, (p + 1) * pod)
            for m in range(pod):
                bits_equal(out[p * pod + m], fout[p],
                           f"hierarchical step {s} pod {p}: result")
            for f in TENSOR_FIELDS:
                hv = getattr(hs, f)[rows]
                for m in range(1, pod):
                    bits_equal(hv[m], hv[0], f"step {s} pod {p}: {f}")
            for f in ("residual", "boundaries", "local_threshold",
                      "global_threshold", "last_local_count",
                      "last_global_count", "step"):
                bits_equal(getattr(hs, f)[p * pod], getattr(fs, f)[p],
                           f"hierarchical step {s} pod {p}: {f}")
            bits_equal(hs.last_wire_bytes_inter[p * pod],
                       fs.last_wire_bytes[p],
                       f"hierarchical step {s} pod {p}: inter wire")
        rec = {"step": s + 1, "collective": "dense" if dense else "oktopk",
               "exact": exact, "ms": a.elapsed_time(b),
               "last_wire_bytes_intra": float(hs.last_wire_bytes_intra[0]),
               "last_wire_bytes_inter": float(hs.last_wire_bytes_inter[0]),
               "last_volume": float(hs.last_volume[0]),
               "local_count": int(hs.last_local_count[0]),
               "global_count": int(hs.last_global_count[0]),
               "fused_select_calls": calls["fused_select"],
               "compaction_calls": calls["compaction"]}
        recs.append(rec)
        emit({"phase": "hierarchical", **rec})
        if not (dense or exact):
            intra.append(rec["last_wire_bytes_intra"])
            inter.append(rec["last_wire_bytes_inter"])
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("hierarchical: non-finite result")
    assert_launched(launches, SPARSE_KERNELS, "hierarchical")
    reports = hierarchical_volume_report(
        h, sum(intra) / len(intra), sum(inter) / len(inter),
        steps=len(intra))
    for r in reports:
        if not r["conformance_ratio"] <= 1.0:
            raise AssertionError(f"hierarchical: {r['level']} conformance "
                                 f"{r['conformance_ratio']}")
    g = base + 0.3 * torch.randn((W, n), generator=gen, device=dev)
    row = tapped_step(h, g, hs, dev)
    sparse = [r["ms"] for r in recs[1:]]
    emit({"phase": "hierarchical_summary", "n": n, "pods": h.num_pods,
          "pod_size": pod, "outer": h.outer, "k": h.outer_cfg.k,
          "steps": len(recs), "bit_equal_to_flat_on_pod_means": True,
          "dense_step_ms": recs[0]["ms"],
          "median_oktopk_step_ms": statistics.median(sparse),
          "oktopk_step_ms_range": [min(sparse), max(sparse)],
          "budgets": hierarchical_budget_bytes(h),
          "conformance": {r["level"]: r["conformance_ratio"]
                          for r in reports},
          "launches": launches,
          "launches_per_oktopk_step": [
              {"fused_select": r["fused_select_calls"],
               "compaction": r["compaction_calls"]} for r in recs[1:]],
          "max_memory_allocated_gb": peak_gb,
          "quality_tap": {"eff_density": row["eff_density"],
                          "comp_err": row["comp_err"], "row": row}})
    del hs, fs, base, out
    torch.cuda.empty_cache()
    return launches


def train_run(dev, phase: str, compressor: str, sparse_steps: int, algo,
              profile_norm: bool = False, **train_kw):
    """Full-width VGG-16, P = 4 workers stacked on the card, global batch
    64, density 0.02: ``algo.warmup_steps`` dense steps, then
    ``sparse_steps`` through ``compressor``, kernel launch counters set to
    0 just before the steps and read just after. Emits one line per step
    and returns (summary, trainer)."""
    import numpy as np
    import torch
    from oktopk_tpu_torch.config import TrainConfig
    from oktopk_tpu_torch.data import synthetic_batch
    from oktopk_tpu_torch.train.trainer import Trainer

    P, gbs = 4, 64
    ns = train_kw.get("nsteps_update", 1)
    cfg = TrainConfig(dnn="vgg16", batch_size=gbs // (P * ns), lr=0.1,
                      density=0.02, num_workers=P, seed=SEED,
                      compressor=compressor, **train_kw)
    trainer = Trainer(cfg, algo_cfg=algo, device=dev,
                      profile_norm=profile_norm)
    if trainer.algo_cfg.n != N_VGG16:
        raise AssertionError(f"VGG-16 has {trainer.algo_cfg.n} parameters")
    rng = np.random.RandomState(SEED)
    batches = [synthetic_batch("vgg16", gbs, rng)
               for _ in range(algo.warmup_steps + sparse_steps)]
    torch.cuda.synchronize()
    zero_counts()
    steps, times = [], []
    for s, b in enumerate(batches):
        t0 = time.perf_counter()
        m = trainer.train_step(b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        rec = {k: float(v) for k, v in m.items()}
        rec.update(step=s + 1, ms=times[-1],
                   collective=("dense" if s < algo.warmup_steps
                               else compressor))
        steps.append(rec)
        emit({"phase": phase, **rec})
    launches = read_counts()
    losses = [r["loss"] for r in steps]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{compressor}: non-finite loss: {losses}")
    for p in trainer.params:
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"{compressor}: non-finite parameter")
    sparse = steps[algo.warmup_steps:]
    summary = {
        "compressor": compressor, "model": "vgg16", "n": N_VGG16,
        "workers": P, "global_batch": gbs, "steps": len(steps),
        "losses": losses, "median_step_ms": statistics.median(times),
        "median_sparse_step_ms": statistics.median(
            r["ms"] for r in (sparse[1:] or sparse)),
        "volume_per_sparse_step": [r["comm_volume"] for r in sparse],
        "wire_bytes_per_sparse_step": [r["wire_bytes"] for r in sparse],
        "launches": launches,
        "launches_per_sparse_step": {k: v / len(sparse)
                                     for k, v in launches.items()}}
    if profile_norm:
        summary["eps_vs_dense"] = [r["eps_vs_dense"] for r in steps]
    return summary, trainer


def phase_trainer(dev):
    """The main path: five oktopk steps after one dense warmup step."""
    from oktopk_tpu_torch.config import OkTopkConfig
    algo = OkTopkConfig(warmup_steps=1, local_recompute_every=1,
                        global_recompute_every=4)
    summary, _ = train_run(dev, "trainer", "oktopk", 5, algo)
    assert_launched(summary["launches"], SPARSE_KERNELS, "trainer")
    emit({"phase": "trainer_summary", **summary})
    return summary["launches"]


def phase_baselines_trainer(dev):
    """Each baseline at full width: one dense warmup step, then three
    sparse steps (local_recompute_every=2: the first sparse step and the
    second recompute, the third predicts). Returns each path's launches
    by kernel."""
    import torch
    from oktopk_tpu_torch.config import OkTopkConfig
    algo = OkTopkConfig(warmup_steps=1, local_recompute_every=2)
    launches = {}
    for nm in BASELINES:
        summary, trainer = train_run(dev, "baselines_trainer", nm, 3, algo)
        del trainer
        torch.cuda.empty_cache()
        if nm in COMPACTING and summary["launches"]["compaction"] <= 0:
            raise AssertionError(f"{nm}: the compaction kernel never "
                                 "launched on its path")
        launches[nm] = summary["launches"]
        emit({"phase": "baselines_trainer_summary", **summary})
    return launches


def phase_step_options(dev):
    """oktopk at full width with two microbatches per worker (global batch
    64 = 4 workers x 2 x 8), a gradient clip that binds, momentum
    correction and the eps_vs_dense metric."""
    import torch
    from oktopk_tpu_torch.config import OkTopkConfig
    algo = OkTopkConfig(warmup_steps=1, local_recompute_every=1,
                        global_recompute_every=4)
    clip = 0.05
    summary, trainer = train_run(
        dev, "step_options", "oktopk", 3, algo, profile_norm=True,
        nsteps_update=2, grad_clip=clip, momentum_correction=True)
    norms = torch.linalg.vector_norm(trainer.flat, dim=1)
    if not bool(torch.allclose(norms, torch.full_like(norms, clip),
                               rtol=1e-4)):
        raise AssertionError(f"grad_clip {clip} did not bind: {norms}")
    if trainer.optimizer.momentum != 0.0:
        raise AssertionError("momentum correction left SGD momentum on")
    assert_launched(summary["launches"], SPARSE_KERNELS, "step_options")
    if not all(math.isfinite(e) for e in summary["eps_vs_dense"]):
        raise AssertionError(f"eps_vs_dense: {summary['eps_vs_dense']}")
    emit({"phase": "step_options_summary", "nsteps_update": 2,
          "grad_clip": clip, "momentum_correction": True,
          "worker_grad_norms_after_clip": [float(v) for v in norms],
          **summary})
    return summary["launches"]


# the run journal on the main path: VGG-16 through oktopk at
# full width, P = 4 stacked, batch 16 a worker, d = 0.02, bf16 wire
OBS_STEPS = 8
OBS_BUDGET_S = 60.0          # the phase's own budget (both runs)
OBS_ARGV = ["--dnn", "vgg16", "--dataset", "cifar10", "--batch-size", "16",
            "--num-workers", "4", "--density", "0.02", "--wire-dtype",
            "bfloat16", "--warmup-steps", "1", "--lr", "0.01", "--seed",
            str(SEED), "--max-iters", str(OBS_STEPS), "--log-every", "4"]
OBS_FLAGS = ["--obs", "--obs-quality", "--obs-quality-every", "4",
             "--phase-timers", "--trace-at", "5", "--trace-steps", "2"]
OBS_TRACED = (5, 6)          # the steps inside the trace window


def obs_cli_run(dev, argv, logdir: str) -> dict:
    """``main_trainer.main(argv)`` in this process, every Trainer step
    timed on the host clock (the card synchronised after it) and its
    metrics kept, every quality flush timed, and the peak device memory
    above what was allocated before the run; the launch counters set to 0
    just before the run and read just after."""
    import gc

    import torch
    from oktopk_tpu_torch.train import main_trainer
    from oktopk_tpu_torch.train.trainer import Trainer

    recs, flush_ms = [], []
    step, flush = Trainer.train_step, Trainer._flush_quality

    def timed_step(self, batch):
        t0 = time.perf_counter()
        m = step(self, batch)
        torch.cuda.synchronize(dev)
        recs.append(({k: float(v) for k, v in m.items()},
                     (time.perf_counter() - t0) * 1e3))
        return m

    def timed_flush(self, at):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        flush(self, at)
        flush_ms.append((time.perf_counter() - t0) * 1e3)

    Trainer.train_step, Trainer._flush_quality = timed_step, timed_flush
    try:
        gc.collect()        # an earlier run's Trainer (a reference cycle)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        t0 = time.perf_counter()
        rc = main_trainer.main(argv + ["--device", str(dev), "--logdir",
                                       logdir])
        secs = time.perf_counter() - t0
        launches = read_counts()
        peak_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    finally:
        Trainer.train_step, Trainer._flush_quality = step, flush
    if rc != 0 or len(recs) != OBS_STEPS:
        raise AssertionError(f"obs_trainer: main_trainer exit {rc}, "
                             f"{len(recs)} steps")
    cfg, _ = main_trainer.configs(main_trainer.parse_args(argv), 4)
    return {"metrics": [m for m, _ in recs], "ms": [t for _, t in recs],
            "flush_ms": flush_ms, "seconds": secs, "launches": launches,
            "peak_gb": peak_gb,
            "rundir": os.path.join(logdir, cfg.experiment_slug())}


def spread(ms) -> dict:
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}


def trace_kernels(path: str) -> set:
    """The kernel names of a Chrome trace (its ``kernel`` events)."""
    with open(path) as f:
        trace = json.load(f)
    return {e.get("name", "").split("(")[0] for e in trace["traceEvents"]
            if e.get("cat") == "kernel"}


def phase_obs_trainer(dev) -> dict:
    """``main_trainer`` on the main path with the run journal, the quality
    taps, the phase timers and a trace window, then the same steps
    without ``--obs``: the journal, the run directory, the trace and the
    launches checked; losses and volumes bit-identical on and off; a
    regression detector on the off run's median. Returns the launches of
    the journalled run."""
    import shutil
    import tempfile

    import torch
    from oktopk_tpu_torch.autotune.journal import read_journal
    from oktopk_tpu_torch.obs.events import validate_journal
    from oktopk_tpu_torch.obs.journal import EventBus
    from oktopk_tpu_torch.obs.regress import RegressionDetector
    from oktopk_tpu_torch.utils.profiling import device_memory_stats

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="oktopk_obs_")
    try:
        on = obs_cli_run(dev, OBS_ARGV + OBS_FLAGS,
                         os.path.join(root, "on"))
        mem = device_memory_stats(dev)
        off = obs_cli_run(dev, OBS_ARGV, os.path.join(root, "off"))
        rundir = on["rundir"]
        journal = read_journal(os.path.join(rundir, "run_journal.jsonl"))
        problems = validate_journal(journal)
        kinds = [e["event"] for e in journal]
        header = journal[0]
        if problems or kinds.count("header") != 1 or \
                header.get("device_kind") != torch.cuda.get_device_name(0):
            raise AssertionError(f"obs_trainer: journal {problems[:5]}, "
                                 f"header {header}")
        steps = [e for e in journal if e["event"] == "step"]
        if len(steps) != OBS_STEPS or not all(
                e["wire_bytes"] > 0 for e in steps):
            raise AssertionError(f"obs_trainer: step events {steps}")
        quality = [e for e in journal if e["event"] == "quality"]
        rollups = [e for e in journal if e["event"] == "quality_rollup"]
        if sum(e["count"] for e in quality) != OBS_STEPS or \
                len(rollups) != len(quality):
            raise AssertionError(f"obs_trainer: {len(quality)} quality "
                                 f"events, {len(rollups)} rollups")
        volume = [e for e in journal if e["event"] == "volume_report"]
        if len(volume) != 1 or volume[0]["algo"] != "oktopk" or \
                not volume[0]["budget_bytes"] > 0:
            raise AssertionError(f"obs_trainer: volume reports {volume}")
        for f in ("rank0.log", "scalars.csv"):
            if not os.path.isfile(os.path.join(rundir, f)):
                raise AssertionError(f"obs_trainer: no {f} in {rundir}")
        trace = os.path.join(rundir, "trace", "trace_steps%d-%d.json"
                             % OBS_TRACED)
        traced = trace_kernels(trace)
        for kern in ("fs_sweep", "cp_compact"):
            if kern not in traced:
                raise AssertionError(f"obs_trainer: {kern} not in the "
                                     f"trace ({sorted(traced)[:20]})")
        assert_launched(on["launches"], SPARSE_KERNELS, "obs_trainer")
        for key in ("loss", "comm_volume", "wire_bytes"):
            a = [m[key] for m in on["metrics"]]
            b = [m[key] for m in off["metrics"]]
            if a != b:
                raise AssertionError(f"obs_trainer: {key} with the journal "
                                     f"{a}, without {b}")
        if [e["loss"] for e in steps] != [m["loss"] for m in on["metrics"]]:
            raise AssertionError("obs_trainer: journalled losses differ "
                                 "from the steps'")
        # the steady oktopk steps (after the dense step and the first,
        # exact, oktopk step) outside the trace window, both runs
        steady = [i for i in range(2, OBS_STEPS)
                  if i + 1 not in OBS_TRACED]
        on_ms = [on["ms"][i] for i in steady]
        off_ms = [off["ms"][i] for i in steady]
        base = statistics.median(off_ms)
        planted = RegressionDetector(base, warmup_windows=0, bus=EventBus())
        if planted.observe(1, 3.0 * base) is None:
            raise AssertionError("obs_trainer: a planted 3x step was not "
                                 "flagged")
        real = RegressionDetector(base, warmup_windows=0)
        for i in steady:
            real.observe(i + 1, on["ms"][i])
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        secs = time.perf_counter() - t_phase
        out = {"phase": "obs_trainer", "card": smi,
               "steps": OBS_STEPS, "steady_steps": [i + 1 for i in steady],
               "step_ms_obs": spread(on_ms), "step_ms_no_obs": spread(off_ms),
               "step_ms_obs_all": on["ms"], "step_ms_no_obs_all": off["ms"],
               "flush_ms": on["flush_ms"], "quality_events": len(quality),
               "rollups": len(rollups),
               "breaches": sorted({b for r in rollups
                                   for b in r["breaches"]}),
               "conformance_ratio": volume[0]["conformance_ratio"],
               "device_memory": mem, "peak_gb_obs": on["peak_gb"],
               "peak_gb_no_obs": off["peak_gb"],
               "journal_events": len(journal),
               "trace_mb": os.path.getsize(trace) / 1e6,
               "losses": [m["loss"] for m in on["metrics"]],
               "bit_identical_on_off": True,
               "regress_flags_on_real_steps": real.flagged,
               "launches": on["launches"], "launches_off": off["launches"],
               "run_seconds": {"obs": on["seconds"], "no_obs": off["seconds"]},
               "seconds": secs}
        emit(out)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if secs > OBS_BUDGET_S:
        raise AssertionError(f"obs_trainer took {secs:.1f} s, over its "
                             f"{OBS_BUDGET_S:.0f} s budget")
    return on["launches"]


def vgg16_bucket_sizes():
    """The flat sizes of VGG-16's two buckets (``bucket_partition`` over
    the leaves in JAX order; bucket 0 holds the last layers)."""
    import torch
    from oktopk_tpu_torch.models import create_model
    from oktopk_tpu_torch.optim.distributed import (bucket_partition,
                                                    bucket_sizes)
    with torch.device("meta"):
        leaves = [p for _, p, _ in create_model("vgg16").jax_leaves()]
    return bucket_sizes(leaves, bucket_partition(leaves, 2))


RES_BUDGET_S = 60.0           # the resilience phase's own budget
RES_ARGV = ["--dnn", "vgg16", "--dataset", "cifar10", "--batch-size", "16",
            "--num-workers", "4", "--density", "0.02", "--wire-dtype",
            "bfloat16", "--num-buckets", "2", "--lr", "0.01", "--seed",
            str(SEED)]
# the CPU tests' cadences (tests/test_resilience.py::_trainer): no dense
# warmup, every threshold, region and global select recomputed each step
RES_ALGO = dict(warmup_steps=0, local_recompute_every=1,
                global_recompute_every=1, repartition_every=1)
RES_N = N_VGG16
RES_K = 2                     # the NaN's attempted step
RES_NEVER = 10**9


def res_trainer(dev, plan=None, flags=(), **cfg):
    """VGG-16 through ``main_trainer.build_trainer`` with ``flags`` (add
    ``--resilience`` for the guard), the cadence overrides and ``plan``:
    (trainer, batch iterator)."""
    from oktopk_tpu_torch.train import main_trainer
    args = main_trainer.parse_args(RES_ARGV + ["--device", str(dev)]
                                   + list(flags))
    trainer, data, _, _ = main_trainer.build_trainer(
        args, config_overrides=dict(resilience_cooldown=0, **cfg),
        algo_overrides=RES_ALGO, fault_plan=plan)
    if trainer.algo_cfg.n != RES_N or len(trainer.grad_step.states) != 2:
        raise AssertionError("resilience: not VGG-16 over two buckets")
    return trainer, data


def res_snapshot(trainer) -> dict:
    """Copies of what a skipped step must leave as it was, by name."""
    gs = trainer.grad_step
    return {"params": [p.detach().clone() for p in trainer.params],
            "momentum": [b.clone() for b in trainer.optimizer.momentum_buf],
            "sgd_step": [trainer.optimizer.step.clone()],
            "batchnorm": [b.clone() for b in trainer.stats],
            "residual": [s.residual.clone() for s in gs.states],
            "local_threshold": [s.local_threshold.clone()
                                for s in gs.states],
            "global_threshold": [s.global_threshold.clone()
                                 for s in gs.states]}


def same_bits(a, b) -> bool:
    """``a`` and ``b`` hold the same bits (NaNs and signed zeros too)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32,
                8: torch.int64}[a.element_size()]
        a, b = a.view(view), b.view(view)
    return torch.equal(a, b)


def res_decisions(trainer, steps, batches) -> dict:
    """``steps`` steps on ``batches``, each supervised: the per-step
    skip flags, anomaly flags, strikes after each check, the dense
    fallbacks and the health journal's (event, step) pairs."""
    skips, flags, strikes = [], [], []
    for i in range(steps):
        m = trainer.train_step(batches[i])
        trainer.supervise(i + 1, m)
        skips.append(int(m["step_skipped"]))
        flags.append(m["bucket_anomalies"].tolist())
        strikes.append(list(trainer.supervisor.strikes))
    return {"skips": skips, "anomalies": flags, "strikes": strikes,
            "forced_dense": list(trainer.supervisor.forced_dense),
            "journal": [(e["event"], e.get("step"))
                        for e in trainer.supervisor.journal.entries]}


def res_mnist_decisions(device) -> dict:
    """The CPU tests' plans on mnistnet with their ``_trainer`` config
    (P = 4 stacked, a global batch of 8, d = 0.05, every cadence 1,
    tests/test_torch_resilience.py): the guarded NaN run and the wire
    bit-flip run, on ``device``."""
    import numpy as np
    from oktopk_tpu_torch.collectives import wire
    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
    from oktopk_tpu_torch.data import synthetic_batch
    from oktopk_tpu_torch.resilience import FaultPlan, FaultSpec
    from oktopk_tpu_torch.resilience.faults import make_wire_hook
    from oktopk_tpu_torch.train.trainer import Trainer

    def trainer(plan=None, nb=1):
        cfg = TrainConfig(dnn="mnistnet", dataset="mnist", batch_size=8,
                          lr=0.05, compressor="oktopk", density=0.05,
                          num_buckets=nb, num_workers=4, resilience=True,
                          resilience_cooldown=0, resilience_strikes=3)
        return Trainer(cfg, algo_cfg=OkTopkConfig(**RES_ALGO), warmup=False,
                       device=device, fault_plan=plan)

    rng = np.random.RandomState(9)
    batches = [synthetic_batch("mnistnet", 8, rng) for _ in range(7)]
    nan = res_decisions(trainer(FaultPlan((FaultSpec(
        "nan_grad", step=RES_K, worker=1, count=3),))), 5, batches)
    tr = trainer(nb=2)
    prev = wire.install_wire_fault(make_wire_hook(FaultPlan((FaultSpec(
        "wire_bitflip", step=1, duration=20, worker=2, bucket=1),)),
        tr.comm))
    try:
        bitflip = res_decisions(tr, 7, batches)
    finally:
        wire.install_wire_fault(prev)
    return {"nan_grad": nan, "wire_bitflip": bitflip}


def phase_resilience(dev) -> dict:
    """The numeric-health guard, the supervisor, the density backoff and
    a chip loss on VGG-16 at full width (P = 4 stacked, global batch 64,
    d = 0.02, bf16 wire, two buckets, through ``main_trainer``), then the
    CPU tests' plans on mnistnet card against CPU, then the guarded step's
    cost. Returns the launches of the guarded NaN run (the path ``vgg16
    resilience``)."""
    import torch
    from oktopk_tpu_torch.collectives import wire
    from oktopk_tpu_torch.resilience import FaultPlan, FaultSpec
    from oktopk_tpu_torch.resilience.faults import make_wire_hook

    t_phase = time.perf_counter()
    out = {"phase": "resilience", "model": "vgg16", "n": RES_N,
           "workers": 4, "global_batch": 64, "num_buckets": 2}

    # 1. a NaN on worker 1 at attempted step k: that step skips, leaving
    # every state bit-identical, against a never-firing control run
    def nan_plan(step):
        return FaultPlan((FaultSpec("nan_grad", step=step, worker=1,
                                    count=3),))

    tr, data = res_trainer(dev, nan_plan(RES_K), ["--resilience"])
    batches = [next(data) for _ in range(5)]
    torch.cuda.synchronize()
    zero_counts()
    recs = []
    for i, b in enumerate(batches):
        if i == RES_K:
            before = res_snapshot(tr)
            counters = ([int(s.step[0]) for s in tr.grad_step.states],
                        int(tr.grad_step.health.step))
        m = tr.train_step(b)
        tr.supervise(i + 1, m)
        recs.append({k: float(v.to(torch.float64).mean())
                     for k, v in m.items()})
        if i == RES_K:
            after = res_snapshot(tr)
            moved = [k for k in before if not all(
                same_bits(x, y) for x, y in zip(before[k], after[k]))]
            ahead = ([int(s.step[0]) for s in tr.grad_step.states],
                     int(tr.grad_step.health.step))
    torch.cuda.synchronize()
    launches = read_counts()
    skips = [int(r["step_skipped"]) for r in recs]
    if skips != [1 if i == RES_K else 0 for i in range(5)] or moved:
        raise AssertionError(f"resilience: skips {skips}, states moved "
                             f"across the skip: {moved}")
    if ahead != ([c + 1 for c in counters[0]], counters[1] + 1) or int(
            tr.grad_step.health.steps_skipped) != 1:
        raise AssertionError(f"resilience: counters {counters} -> {ahead}")
    assert_launched(launches, SPARSE_KERNELS, "resilience")
    ctl, _ = res_trainer(dev, nan_plan(RES_NEVER), ["--resilience"])
    ctl_losses = [float(ctl.train_step(b)["loss"])
                  for i, b in enumerate(batches) if i != RES_K]
    losses = [r["loss"] for i, r in enumerate(recs) if i != RES_K]
    if losses != ctl_losses:
        raise AssertionError(f"resilience: losses {losses} against the "
                             f"never-firing control's {ctl_losses}")
    out["nan_grad"] = {"skips": skips, "losses": [r["loss"] for r in recs],
                       "control_losses": ctl_losses,
                       "bit_identical": sorted(before),
                       "counters": [counters, ahead],
                       "launches": launches,
                       "seconds": time.perf_counter() - t_phase}
    t0 = time.perf_counter()
    del tr, ctl, before, after

    # 2. a bit-flipped payload from worker 2 on bucket 1: three strikes,
    # bucket 1 falls back to dense, bucket 0's kernels go on
    tr, data = res_trainer(dev, flags=["--resilience",
                                       "--resilience-strikes", "3"])
    prev = wire.install_wire_fault(make_wire_hook(FaultPlan((FaultSpec(
        "wire_bitflip", step=1, duration=20, worker=2, bucket=1),)),
        tr.comm))
    per_step = []
    try:
        skips = []
        for i in range(7):
            b = next(data)
            torch.cuda.synchronize()
            zero_counts()
            m = tr.train_step(b)
            torch.cuda.synchronize()
            per_step.append(read_counts())
            tr.supervise(i + 1, m)
            skips.append(int(m["step_skipped"]))
    finally:
        wire.install_wire_fault(prev)
    events = [e["event"] for e in tr.supervisor.journal.entries
              if e["event"] != "header"]
    # both buckets launch each sparse kernel equally often a step until
    # bucket 1 falls back (after step 4's supervision); then bucket 0
    # alone launches them: exactly half as often
    full = per_step[0]
    if (skips != [0, 1, 1, 1, 0, 0, 0]
            or tr.supervisor.forced_dense != [1]
            or tr.grad_step.names != ["oktopk", "dense"]
            or events != ["guard_trip"] * 3 + ["fallback"]
            or not all(full[k] > 0 and full[k] % 2 == 0
                       for k in SPARSE_KERNELS)
            or any(c[k] != full[k] for c in per_step[:4]
                   for k in SPARSE_KERNELS)
            or any(2 * c[k] != full[k] for c in per_step[4:]
                   for k in SPARSE_KERNELS)):
        raise AssertionError(
            f"resilience: bit-flip skips {skips}, fallbacks "
            f"{tr.supervisor.forced_dense}, plan {tr.grad_step.names}, "
            f"journal {events}, launches per step {per_step}")
    out["wire_bitflip"] = {"skips": skips, "forced_dense": [1],
                           "journal": events,
                           "launches_per_step": per_step,
                           "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    del tr

    # 3. guard pressure backs the density off, a clean streak re-advances
    # it; the re-plans keep every residual
    tr, data = res_trainer(
        dev, FaultPlan((FaultSpec("scale_grad", step=1, duration=2,
                                  scale=1e8),)),
        ["--resilience", "--resilience-density-backoff",
         "--resilience-abs-limit", "1e3", "--resilience-near-ratio", "0.5",
         "--resilience-backoff-steps", "2",
         "--resilience-backoff-max-level", "1",
         "--resilience-clean-streak", "2", "--resilience-strikes", "99"],
        resilience_divergence_limit=99)
    replans, skips = [], []
    for i in range(6):
        m = tr.train_step(next(data))
        skips.append(int(m["step_skipped"]))
        res = [s.residual.clone() for s in tr.grad_step.states]
        scale = tr._density_scale
        tr.supervise(i + 1, m)
        if tr._density_scale != scale:
            replans.append({"step": i + 1, "scale": tr._density_scale,
                            "densities": [c.density
                                          for c in tr.grad_step.cfgs],
                            "residuals_kept": all(
                                same_bits(a, s.residual) for a, s in zip(
                                    res, tr.grad_step.states))})
    changes = [(e["step"], e["direction"])
               for e in tr.supervisor.journal.entries
               if e["event"] == "density_backoff"]
    if ([d for _, d in changes] != ["backoff", "advance"]
            or not all(r["residuals_kept"] for r in replans)
            or skips != [0, 1, 1, 0, 0, 0]):
        raise AssertionError(f"resilience: backoff {changes}, re-plans "
                             f"{replans}, skips {skips}")
    out["density_backoff"] = {"skips": skips, "changes": changes,
                              "replans": replans,
                              "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    del tr

    # 4. worker 3's chip dies at step 3: remesh to three workers
    tr, data = res_trainer(dev, FaultPlan((FaultSpec("chip_loss", step=3,
                                                     worker=3),)),
                           ["--resilience"])
    losses = []
    for step in range(1, 6):
        b = next(data)
        if step > 3:            # three workers' share of the batch
            b = {k: v[:len(v) * 3 // 4] for k, v in b.items()}
        m = tr.train_step(b)
        losses.append(float(m["loss"]))
        if step == 3:
            pre = [p.detach().clone() for p in tr.params]
        tr.supervise(step, m)
        if step == 3:
            kept = all(same_bits(a, p) for a, p in zip(pre, tr.params))
    remesh = [e for e in tr.supervisor.journal.entries
              if e["event"] == "remesh"]
    if (not kept or tr.comm.size != 3 or len(remesh) != 1
            or remesh[0]["new_world"] != 3
            or not {"health", "supervisor"} <= set(remesh[0]["carried"])
            or not all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"resilience: remesh {remesh}, params kept "
                             f"{kept}, losses {losses}")
    out["chip_loss"] = {"losses": losses, "remesh": remesh[0],
                        "params_bit_identical": kept,
                        "seconds": time.perf_counter() - t0}
    del tr, pre

    # 5. the CPU tests' plans on mnistnet: card against CPU
    t0 = time.perf_counter()
    card = res_mnist_decisions(dev)
    cpu = res_mnist_decisions("cpu")
    if card != cpu:
        raise AssertionError(f"resilience: mnistnet decisions on the card "
                             f"{card}, on the CPU {cpu}")
    out["mnistnet_card_vs_cpu"] = {"equal": True, "decisions": card,
                                   "seconds": time.perf_counter() - t0}

    # 6. the guarded step against the unguarded one, in turns, then one
    # profiled steady step of each
    t_cost = time.perf_counter()
    on, data_on = res_trainer(dev, flags=["--resilience"])
    off, data_off = res_trainer(dev)
    ms = {"guarded": [], "unguarded": []}
    order = [("guarded", on, data_on), ("unguarded", off, data_off)]
    for i in range(8):
        for name, t, d in (order if i % 2 == 0 else order[::-1]):
            b = next(d)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.train_step(b)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    prof = {}
    for name, t, d in order:
        b = next(d)
        counts, by_op = profile_window(lambda: t.train_step(b), 1)
        prof[name] = (counts, by_op)
    (c_on, d_on), (c_off, d_off) = prof["guarded"], prof["unguarded"]
    added = {k: c_on.get(k, 0) - c_off.get(k, 0)
             for k in set(c_on) | set(c_off)
             if c_on.get(k, 0) != c_off.get(k, 0)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    steady = slice(2, None)    # after each trainer's first two steps
    out["cost"] = {
        "card": smi, "steady_steps": len(ms["guarded"][steady]),
        "step_ms_guarded": spread(ms["guarded"][steady]),
        "step_ms_unguarded": spread(ms["unguarded"][steady]),
        "step_ms_guarded_all": ms["guarded"],
        "step_ms_unguarded_all": ms["unguarded"],
        "device_ms_guarded": sum(d_on.values()),
        "device_ms_unguarded": sum(d_off.values()),
        "launches_guarded": sum(c_on.values()),
        "launches_unguarded": sum(c_off.values()),
        "added_launches_by_op": dict(sorted(
            added.items(), key=lambda kv: -abs(kv[1]))[:12]),
        "seconds": time.perf_counter() - t_cost}
    del on, off
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    emit(out)
    if secs > RES_BUDGET_S:
        raise AssertionError(f"resilience took {secs:.1f} s, over its "
                             f"{RES_BUDGET_S:.0f} s budget")
    return launches


AUTOTUNE_BUDGET_S = 60.0      # the autotune phase's own budget
AUTOTUNE_ARGV = ["--dnn", "vgg16", "--dataset", "cifar10", "--num-workers",
                 "4", "--batch-size", "16", "--density", "0.02",
                 "--wire-dtype", "bfloat16", "--num-buckets", "2",
                 "--autotune", "--autotune-candidates", "dense,oktopk",
                 "--autotune-trial-steps", "3", "--obs", "--lr", "0.01",
                 "--seed", str(SEED)]
AUTOTUNE_STEPS = 6
# the CPU tests' fake-seam Trainer (tests/test_torch_autotune.py: JAX's
# TestTrainerIntegration config)
AUTOTUNE_MNIST = dict(dnn="mnistnet", dataset="mnist", batch_size=8,
                      lr=0.1, compressor="oktopk", density=0.02,
                      num_workers=8, num_buckets=2, autotune=True,
                      autotune_candidates=("dense", "oktopk"),
                      autotune_trial_steps=1, autotune_retune_every=50)
BENCH_CMD = ["--algo", "oktopk", "--n", "1048576", "--density", "0.01",
             "--steps", "5"]


def crossover_fake_ms(algo, n, density):
    """The JAX tests' synthetic fabric (tests/test_autotune.py:27-33):
    dense wins small buckets, oktopk large ones."""
    if algo == "dense":
        return 0.5 + n * 1e-6
    return 2.0 + density * n * 2e-6


def tuner_events(trainer, start: int = 0) -> list:
    """The run journal's tuner events from entry ``start`` on."""
    return [e for e in trainer.run_journal.entries[start:]
            if e["event"] in ("retune", "calibration", "autotune_decision")]


def check_decisions(decisions, where: str) -> None:
    """Raise unless each decision is a trial that chose its fastest
    measured candidate."""
    for d in decisions:
        best = min(d["candidates"], key=lambda c: c["measured_ms"])
        if d["reason"] != "trial" or d["chosen"]["algo"] != best["algo"] \
                or d["chosen"]["density"] != best["density"]:
            raise AssertionError(f"{where}: bucket {d['bucket']} chose "
                                 f"{d['chosen']} ({d['reason']}), fastest "
                                 f"{best}")


def bench_in_process(dev, n: int, density: float, steps: int, P: int = 4):
    """The benchmark CLI's loop in this process (its seed, its cadences):
    each timed step's volume."""
    import numpy as np
    import torch
    from oktopk_tpu_torch.collectives.api import (batched_init_state,
                                                  build_allreduce_step)
    from oktopk_tpu_torch.comm import StackedComm
    from oktopk_tpu_torch.config import OkTopkConfig
    cfg = OkTopkConfig(n=n, num_workers=P, density=density, warmup_steps=0,
                       local_recompute_every=1, global_recompute_every=4)
    step = build_allreduce_step("oktopk", cfg, StackedComm(P), warmup=False)
    state = batched_init_state(cfg, dev)
    rng = np.random.RandomState(0)
    base = rng.randn(P, n).astype(np.float32)
    _, state = step(torch.from_numpy(base).to(dev), state)
    vols = []
    for _ in range(steps):
        g = base + 0.3 * rng.randn(P, n).astype(np.float32)
        _, state = step(torch.from_numpy(g).to(dev), state)
        vols.append(float(state.last_volume[0]))
    return vols


def phase_autotune(dev) -> dict:
    """The autotuner on the main path: full-width VGG-16 through
    ``main_trainer.build_trainer --autotune`` (``AUTOTUNE_ARGV``: P = 4
    stacked, batch 16 a worker, d = 0.02, bf16 wire, two buckets) and
    ``Trainer.train`` for ``AUTOTUNE_STEPS`` steps, whose first runs the
    real calibrate -> trial -> policy pass; then a forced re-tune, the
    fake seam on mnistnet card against CPU, the ``latency_retune`` drill
    and the benchmark CLI. Returns the launches of the train run (the
    path ``vgg16 autotune``: the trials', and the planned steps')."""
    import torch
    from oktopk_tpu_torch.ops import compaction
    from oktopk_tpu_torch.resilience import drills
    from oktopk_tpu_torch.train import main_trainer

    t_phase = time.perf_counter()
    out = {"phase": "autotune", "model": "vgg16", "n": N_VGG16,
           "workers": 4, "global_batch": 64, "num_buckets": 2,
           "argv": " ".join(AUTOTUNE_ARGV)}

    # 1. the real trials at full width, inside Trainer.train
    args = main_trainer.parse_args(AUTOTUNE_ARGV + ["--device", str(dev)])
    tr, data, _, _ = main_trainer.build_trainer(args)
    if tr.algo_cfg.n != N_VGG16 or len(tr.grad_step.states) != 2:
        raise AssertionError("autotune: not VGG-16 over two buckets")
    forms, trial, step_ms = [], {}, []
    real_compact, real_autotune = compaction._compact_cuda, tr.autotune
    real_step = tr.train_step

    def compact_by_form(x, t, boundaries, R, cap):
        forms.append((int(R), int(cap)))
        return real_compact(x, t, boundaries, R, cap)

    def counted_autotune(step=0, fake_ms=None):
        torch.cuda.synchronize()
        before, n_forms, t0 = read_counts(), len(forms), time.perf_counter()
        plans = real_autotune(step=step, fake_ms=fake_ms)
        torch.cuda.synchronize()
        after = read_counts()
        trial[step] = {"launches": {k: after[k] - before[k] for k in after},
                       "forms": sorted(set(forms[n_forms:])),
                       "seconds": time.perf_counter() - t0}
        return plans

    def timed_step(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = real_step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return m

    tr.autotune, tr.train_step = counted_autotune, timed_step
    compaction._compact_cuda = compact_by_form
    try:
        torch.cuda.synchronize()
        zero_counts()
        tr.train(data, AUTOTUNE_STEPS, log_every=1)
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        compaction._compact_cuda = real_compact
    events = tuner_events(tr)
    cal = [e for e in events if e["event"] == "calibration"]
    dec = [e for e in events if e["event"] == "autotune_decision"]
    losses = [e["loss"] for e in tr.run_journal.entries
              if e["event"] == "step"]
    if (len(cal) != 1 or cal[0]["source"] != "measured"
            or cal[0]["nsamples"] != 4 or not cal[0]["alpha"] > 0
            or not cal[0]["beta"] > 0
            or not math.isfinite(cal[0]["residual"])):
        raise AssertionError(f"autotune: calibration events {cal}")
    if sorted(d["bucket"] for d in dec) != [0, 1]:
        raise AssertionError(f"autotune: decisions {dec}")
    check_decisions(dec, "autotune")
    plan = [(p.algo, p.density) for p in tr._plans]
    if tr.grad_step.names != [a for a, _ in plan]:
        raise AssertionError(f"autotune: step {tr.grad_step.names}, plan "
                             f"{plan}")
    tl = trial.get(1, {}).get("launches", {})
    tforms = trial.get(1, {}).get("forms", [])
    assert_launched(tl, SPARSE_KERNELS, "autotune trials")
    if not ({R for R, _ in tforms} >= {1, 4}):
        raise AssertionError(f"autotune: the trials' compaction forms "
                             f"{tforms} lack the pack (R = 4) or the "
                             "select (R = 1)")
    if len(losses) != AUTOTUNE_STEPS or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"autotune: losses {losses}")
    out["trials"] = {
        "calibration": {k: cal[0][k] for k in ("alpha", "beta", "residual",
                                               "nsamples", "source")},
        "candidates_ms": [{"bucket": d["bucket"], "n": d["n"],
                           "measured_ms": {c["algo"]: c["measured_ms"]
                                           for c in d["candidates"]},
                           "predicted_ms": {c["algo"]: c["predicted_ms"]
                                            for c in d["candidates"]},
                           "chosen": d["chosen"]["algo"]} for d in dec],
        "plan": plan, "launches": tl, "compaction_forms": tforms,
        "seconds": trial[1]["seconds"]}
    out["planned_steps"] = {"losses": losses, "step_ms": step_ms,
                            "step_ms_after_first": spread(step_ms[1:]),
                            "launches_with_trials": launches}

    # 2. a forced re-tune: retune -> calibration -> autotune_decision, and
    # the step re-planned only if the plan changed
    t0 = time.perf_counter()
    start = len(tr.run_journal.entries)
    old, replans = list(tr._plans), []
    real_replan = tr._replan
    tr._replan = lambda: replans.append(1) or real_replan()
    tr.force_retune(AUTOTUNE_STEPS + 1)
    chain = [e["event"] for e in tuner_events(tr, start)]
    changed = [p.key() for p in tr._plans] != [p.key() for p in old]
    check_decisions([e for e in tuner_events(tr, start)
                     if e["event"] == "autotune_decision"], "re-tune")
    if (chain != ["retune", "calibration", "autotune_decision",
                  "autotune_decision"] or len(replans) != int(changed)):
        raise AssertionError(f"autotune: re-tune chain {chain}, plan "
                             f"changed {changed}, re-plans {len(replans)}")
    out["retune"] = {"chain": chain, "plan_changed": changed,
                     "replans": len(replans),
                     "plan": [(p.algo, p.density) for p in tr._plans],
                     "calibration": {k: e[k] for e in tuner_events(
                         tr, start) if e["event"] == "calibration"
                         for k in ("alpha", "beta", "residual")},
                     "seconds": time.perf_counter() - t0}
    del tr, data
    torch.cuda.empty_cache()

    # 3. the fake seam on mnistnet: the card's plans are the CPU's
    t0 = time.perf_counter()
    from oktopk_tpu_torch.config import TrainConfig
    from oktopk_tpu_torch.train.trainer import Trainer
    seam = {}
    for where in (dev, "cpu"):
        t = Trainer(TrainConfig(**AUTOTUNE_MNIST), warmup=False,
                    device=where)
        seam[str(where)] = [(p.bucket, p.n, p.algo, p.density,
                             p.measured_ms) for p in t.autotune(
                                 step=0, fake_ms=crossover_fake_ms)]
        del t
    card, cpu = seam[str(dev)], seam["cpu"]
    if card != cpu or len({p[2] for p in card}) != 2:
        raise AssertionError(f"autotune: fake-seam plans on the card "
                             f"{card}, on the CPU {cpu}")
    out["fake_seam"] = {"plans": card, "equal_to_cpu": True,
                        "seconds": time.perf_counter() - t0}

    # 4. the latency_retune drill on the card
    t0 = time.perf_counter()
    report = drills.run_drill("latency_retune", device=dev)
    if not report.ok or report.notes["plan"] != "oktopk->dense":
        raise AssertionError("autotune: latency_retune\n" + report.summary())
    out["latency_retune"] = {"checks": [c[0] for c in report.checks],
                             "plan": report.notes["plan"],
                             "retune_at": report.notes["retune_at"],
                             "seconds": time.perf_counter() - t0}

    # 5. the benchmark CLI, its volumes against the same steps here
    t0 = time.perf_counter()
    rc, text = run_cli([sys.executable, "-m",
                        "oktopk_tpu_torch.benchmarks.collectives"]
                       + BENCH_CMD, 300)
    lines = [ln for ln in text.splitlines() if ln.startswith("step ")]
    vols = [float(ln.split("volume")[1].split()[0]) for ln in lines]
    want = bench_in_process(dev, 1 << 20, 0.01, 5)
    if rc != 0 or vols != want:
        raise AssertionError(f"autotune: benchmark CLI exit {rc}, volumes "
                             f"{vols} vs in process {want}\n{text[-3000:]}")
    out["benchmark_cli"] = {"cmd": " ".join(BENCH_CMD), "exit": rc,
                            "lines": text.strip().splitlines(),
                            "volumes_equal": True,
                            "seconds": time.perf_counter() - t0}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    secs = time.perf_counter() - t_phase
    out["card"], out["seconds"] = smi, secs
    emit(out)
    if secs > AUTOTUNE_BUDGET_S:
        raise AssertionError(f"autotune took {secs:.1f} s, over its "
                             f"{AUTOTUNE_BUDGET_S:.0f} s budget")
    return launches


# step anatomy on the main path (obs/anatomy.py, obs/tracing.py):
# VGG-16 at full width, P = 4 stacked, batch 16 a worker, d = 0.02,
# bf16 wire, two buckets
ANATOMY_BUDGET_S = 60.0       # the anatomy phase's own budget
ANAT_ARGV = ["--dnn", "vgg16", "--dataset", "cifar10", "--batch-size", "16",
             "--num-workers", "4", "--density", "0.02", "--wire-dtype",
             "bfloat16", "--num-buckets", "2", "--warmup-steps", "1",
             "--lr", "0.01", "--seed", str(SEED)]
ANAT_TRACE_AT = 3             # the traced step: a predicted oktopk step
ANAT_TURNS = 6                # steps each way, annotations on and off
BUCKET_PHASES = ("select", "stage", "exchange", "combine")


def device_lane(path: str):
    """(contract events on the stream, kernel events) of a Chrome trace."""
    from oktopk_tpu_torch.obs.anatomy import parse_scope_level
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ann = [e for e in events if e.get("cat") == "gpu_user_annotation"
           and parse_scope_level(e.get("name")) is not None]
    return ann, [e for e in events if e.get("cat") == "kernel"]


def check_step_anatomy(a, lane, where: str) -> None:
    """Buckets 0 and 1 with the four bucket phases and bucket -1 with
    fwd_bwd and optimizer, each in the analysis and on the stream."""
    from oktopk_tpu_torch.obs.anatomy import parse_scope_level
    if a is None:
        raise AssertionError(f"{where}: no anatomy from the trace")
    seen = {parse_scope_level(e["name"])[:2] for e in lane}
    want = {(ph, b) for b in (0, 1) for ph in BUCKET_PHASES} | {
        ("fwd_bwd", None), ("optimizer", None)}
    if not want <= seen:
        raise AssertionError(f"{where}: not on the device lane: "
                             f"{sorted(want - seen, key=str)}")
    for b in (0, 1):
        if not set(BUCKET_PHASES) <= set(a["buckets"].get(b, {})):
            raise AssertionError(f"{where}: bucket {b} has "
                                 f"{sorted(a['buckets'].get(b, {}))}")
    if not {"fwd_bwd", "optimizer"} <= set(a["buckets"].get(-1, {})):
        raise AssertionError(f"{where}: bucket -1 has "
                             f"{sorted(a['buckets'].get(-1, {}))}")


def phase_ms(a) -> dict:
    return {str(b): {ph: d["ms"] for ph, d in phases.items()}
            for b, phases in a["buckets"].items()}


def backward_coverage(lane, kernels) -> dict:
    """The kernels from the step's first ``anat/fwd_bwd`` range on the
    stream to its first other range (bucket 0's container), and how many
    of them lie inside an ``anat/fwd_bwd`` range there (the main
    thread's, and with ``backward_scope`` each backward's, opened on
    autograd's device thread)."""
    fb = [e for e in lane if e["name"] == "anat/fwd_bwd"]
    start = min(e["ts"] for e in fb)
    end = min(e["ts"] for e in lane if e["name"] != "anat/fwd_bwd"
              and e["ts"] >= start)
    pre = [k for k in kernels if start <= k["ts"] < end]
    inside = [k for k in pre if any(
        s["ts"] <= k["ts"] and k["ts"] + k.get("dur", 0)
        <= s["ts"] + s["dur"] + 1e-3 for s in fb)]
    return {"kernels": len(pre), "covered": len(inside),
            "fwd_bwd_ranges": len(fb)}


def anatomy_turns(dev, root: str) -> dict:
    """Two trainers from one seed, one with the phase ranges on and one
    with them off, ``ANAT_TURNS`` steps each in turns (on, off, off, on,
    ...): host ms of each step (card synchronised), first without a
    profiler, then each step inside its own profiler window (where the
    ranges open); losses bit-identical. Then one more profiled step of
    each with the ranges on, the first without ``backward_scope``: how
    much of the fwd/bwd's kernels the ranges cover without it and with
    it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from oktopk_tpu_torch.obs import anatomy
    from oktopk_tpu_torch.train import main_trainer
    from oktopk_tpu_torch.train import trainer as trainer_mod

    args = main_trainer.parse_args(ANAT_ARGV + ["--device", str(dev)])
    pair = {}
    for key in ("on", "off"):
        tr, data, _, _ = main_trainer.build_trainer(args)
        pair[key] = (tr, data)
    out = {"host_ms": {"on": [], "off": []},
           "host_ms_profiled": {"on": [], "off": []},
           "losses": {"on": [], "off": []}}

    def step(key, profiled, export=None):
        tr, data = pair[key]
        batch = next(data)
        prev = anatomy.set_annotations(key == "on" or export is not None)
        try:
            torch.cuda.synchronize(dev)
            prof = (profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
                    if profiled else None)
            if prof is not None:
                prof.start()
            t0 = time.perf_counter()
            m = tr.train_step(batch)
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
            if prof is not None:
                prof.stop()
            if export is not None:
                prof.export_chrome_trace(export)
                return
        finally:
            anatomy.set_annotations(prev)
        out["host_ms_profiled" if profiled else "host_ms"][key].append(ms)
        out["losses"][key].append(float(m["loss"]))

    # two steps each first (the dense warmup, the first exact step),
    # then the timed predicted steps
    for key in ("on", "off", "off", "on"):
        step(key, False)
    out["host_ms"] = {"on": [], "off": []}
    out["losses"] = {"on": [], "off": []}
    for i in range(ANAT_TURNS):
        for key in (("on", "off") if i % 2 == 0 else ("off", "on")):
            step(key, False)
    for i in range(ANAT_TURNS):
        for key in (("on", "off") if i % 2 == 0 else ("off", "on")):
            step(key, True)
    if out["losses"]["on"] != out["losses"]["off"]:
        raise AssertionError(f"anatomy: losses with the ranges "
                             f"{out['losses']['on']}, without "
                             f"{out['losses']['off']}")
    scoped = trainer_mod.backward_scope
    for key, fix in (("off", False), ("on", True)):
        path = os.path.join(root, f"backward_scope_{fix}.json")
        trainer_mod.backward_scope = scoped if fix else (lambda loss: loss)
        try:
            step(key, True, export=path)
        finally:
            trainer_mod.backward_scope = scoped
        out[f"fwd_bwd_coverage_{'with' if fix else 'without'}"
            "_backward_scope"] = backward_coverage(*device_lane(path))
    del pair
    return out


def phase_anatomy(dev) -> dict:
    """The step anatomy on the main path: (a) the pipeline capture at
    VGG-16's two bucket sizes; (b) ``main_trainer --obs --trace-at 3
    --trace-steps 1`` (two buckets), its Chrome trace through
    ``analyze_capture``: both buckets' four phases and fwd_bwd and
    optimizer, all on the stream, and how much of the fwd/bwd's kernels
    its ranges cover; (c) the phase ranges on against off, six steps
    each in turns, without and then with a profiler running: losses
    bit-identical, host ms; (d) ``--resilience --obs
    --obs-trace-on-anomaly`` with the resilience phase's NaN plan:
    exactly one ``trace_captured`` after the ``guard_trip``, its trace
    written, with contract events on the stream. Returns the launches of
    (b)'s run (the path ``vgg16 anatomy``)."""
    import shutil
    import tempfile

    import torch
    from oktopk_tpu_torch.autotune.journal import read_journal
    from oktopk_tpu_torch.comm import StackedComm
    from oktopk_tpu_torch.config import OkTopkConfig
    from oktopk_tpu_torch.obs.anatomy import (analyze_capture,
                                              capture_pipeline_anatomy)
    from oktopk_tpu_torch.obs.events import validate_journal
    from oktopk_tpu_torch.obs.journal import EventBus, RunJournal
    from oktopk_tpu_torch.resilience import FaultPlan, FaultSpec
    from oktopk_tpu_torch.train import main_trainer

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="oktopk_anatomy_")
    out = {"phase": "anatomy", "model": "vgg16", "n": N_VGG16,
           "workers": 4, "global_batch": 64, "num_buckets": 2}
    try:
        # (a) the pipeline capture at the two buckets' sizes
        sizes = vgg16_bucket_sizes()
        cfg = OkTopkConfig(n=N_VGG16, num_workers=4, density=0.02)
        bus = EventBus()
        journal = RunJournal(None, bus)
        zero_counts()
        t0 = time.perf_counter()
        a = capture_pipeline_anatomy(cfg, StackedComm(4),
                                     os.path.join(root, "capture"),
                                     bucket_sizes=sizes, bus=bus,
                                     device=dev)
        cap_s = time.perf_counter() - t0
        cap_launches = read_counts()
        if a is None:
            raise AssertionError("anatomy: the pipeline capture could not "
                                 "start the profiler")
        lane, _ = device_lane(os.path.join(root, "capture",
                                           "anatomy.pt.trace.json"))
        check_step_anatomy(a, lane, "anatomy capture")
        if cap_launches["compaction"] <= 0 or validate_journal(
                journal.entries):
            raise AssertionError(f"anatomy capture: launches "
                                 f"{cap_launches}, journal "
                                 f"{validate_journal(journal.entries)}")
        out["capture"] = {"bucket_sizes": sizes, "phase_ms": phase_ms(a),
                          "overlap_ratio": a["overlap_ratio"],
                          "step_ms": a["step_ms"], "ideal_ms": a["ideal_ms"],
                          "compute_ms": a["compute_ms"],
                          "comm_ms": a["comm_ms"],
                          "critical_phase": a["critical_phase"],
                          "launches": cap_launches, "seconds": cap_s}

        # (b) one real step's trace through main_trainer
        logdir = os.path.join(root, "cli")
        argv = ANAT_ARGV + ["--max-iters", str(ANAT_TRACE_AT + 1),
                            "--log-every", str(ANAT_TRACE_AT + 1),
                            "--obs", "--trace-at", str(ANAT_TRACE_AT),
                            "--trace-steps", "1", "--device", str(dev),
                            "--logdir", logdir]
        torch.cuda.synchronize(dev)
        zero_counts()
        t0 = time.perf_counter()
        rc = main_trainer.main(argv)
        cli_s = time.perf_counter() - t0
        launches = read_counts()
        if rc != 0:
            raise AssertionError(f"anatomy: main_trainer exit {rc}")
        assert_launched(launches, SPARSE_KERNELS, "anatomy main_trainer")
        ccfg, _ = main_trainer.configs(main_trainer.parse_args(argv), 4)
        trace = os.path.join(logdir, ccfg.experiment_slug(), "trace",
                             f"trace_steps{ANAT_TRACE_AT}-"
                             f"{ANAT_TRACE_AT}.json")
        bus = EventBus()
        journal = RunJournal(None, bus)
        a = analyze_capture(trace, bus=bus, step=ANAT_TRACE_AT)
        lane, kernels = device_lane(trace)
        check_step_anatomy(a, lane, "anatomy step trace")
        cover = backward_coverage(lane, kernels)
        if cover["covered"] != cover["kernels"]:
            raise AssertionError(f"anatomy: the fwd_bwd ranges cover "
                                 f"{cover['covered']} of the "
                                 f"{cover['kernels']} kernels before the "
                                 "first select")
        with open(trace) as f:
            host = [e for e in json.load(f)["traceEvents"]
                    if e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith("anat")]
        out["step"] = {"phase_ms": phase_ms(a),
                       "overlap_ratio": a["overlap_ratio"],
                       "step_ms": a["step_ms"], "ideal_ms": a["ideal_ms"],
                       "compute_ms": a["compute_ms"],
                       "comm_ms": a["comm_ms"],
                       "critical_path": a["critical_path"],
                       "critical_phase": a["critical_phase"],
                       "device_ranges": len(lane), "host_ranges": len(host),
                       "host_ranges_by_thread": dict(collections.Counter(
                           e.get("tid") for e in host)),
                       "fwd_bwd_coverage": cover, "launches": launches,
                       "journal_ok": validate_journal(journal.entries) == [],
                       "seconds": cli_s}

        # (c) the ranges on against off, in turns
        out["turns"] = anatomy_turns(dev, root)
        torch.cuda.empty_cache()

        # (d) the anomaly window on a NaN
        plan = FaultPlan((FaultSpec("nan_grad", step=RES_K, worker=1,
                                    count=3),))
        tr, data = res_trainer(dev, plan, [
            "--resilience", "--obs", "--obs-trace-on-anomaly",
            "--obs-trace-steps", "1", "--logdir",
            os.path.join(root, "anomaly")])
        torch.cuda.synchronize(dev)
        zero_counts()
        tr.train(data, 5, log_every=5)
        res_launches = read_counts()
        jpath = tr.cfg.obs_journal
        del tr
        entries = read_journal(jpath)
        kinds = [e["event"] for e in entries]
        caps = [e for e in entries if e["event"] == "trace_captured"]
        if len(caps) != 1 or "guard_trip" not in kinds or \
                kinds.index("guard_trip") > kinds.index("trace_captured"):
            raise AssertionError(f"anatomy: events {kinds}")
        cap = caps[0]
        if cap["logdir"] is None or not cap["trigger"].startswith(
                "guard_trip@"):
            raise AssertionError(f"anatomy: trace_captured {cap}")
        tfile = os.path.join(cap["logdir"], "rank0.pt.trace.json")
        lane, _ = device_lane(tfile)
        if not lane or validate_journal(entries):
            raise AssertionError(f"anatomy: {len(lane)} contract events on "
                                 f"the stream of {tfile}")
        assert_launched(res_launches, SPARSE_KERNELS, "anatomy anomaly")
        out["anomaly"] = {"trace_captured": cap,
                          "guard_trips": [e["step"] for e in entries
                                          if e["event"] == "guard_trip"],
                          "device_ranges": len(lane),
                          "trace_mb": os.path.getsize(tfile) / 1e6,
                          "launches": res_launches}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    secs = time.perf_counter() - t_phase
    turns = out["turns"]
    out.update(card=smi, seconds=secs,
               host_ms_on=spread(turns["host_ms"]["on"]),
               host_ms_off=spread(turns["host_ms"]["off"]),
               host_ms_profiled_on=spread(turns["host_ms_profiled"]["on"]),
               host_ms_profiled_off=spread(
                   turns["host_ms_profiled"]["off"]),
               bit_identical_on_off=True)
    emit(out)
    if secs > ANATOMY_BUDGET_S:
        raise AssertionError(f"anatomy took {secs:.1f} s, over its "
                             f"{ANATOMY_BUDGET_S:.0f} s budget")
    return launches


# item 19 on the card: tests/test_torch_convergence.py's settings
CONV_STEPS = 80
CONV_LIMIT = 1.10


def conv_final_loss(dev, compressor: str, seed: int = 7):
    """mnistnet on the teacher data, P = 8 stacked, batch 8 a worker, lr
    0.05, d = 0.05, no warmup: (mean loss of the last quarter, losses,
    launches)."""
    import torch
    from oktopk_tpu_torch.config import TrainConfig
    from oktopk_tpu_torch.data.synthetic import teacher_iterator
    from oktopk_tpu_torch.train.trainer import Trainer
    cfg = TrainConfig(dnn="mnistnet", dataset="synthetic-teacher",
                      batch_size=8, lr=0.05, compressor=compressor,
                      density=0.05, num_workers=8)
    tr = Trainer(cfg, warmup=False, device=dev)
    it = teacher_iterator("mnistnet", 8 * cfg.num_workers, seed=seed)
    torch.cuda.synchronize(dev)
    zero_counts()
    ms = [tr.train_step(next(it))["loss"] for _ in range(CONV_STEPS)]
    losses = [float(v) for v in torch.stack(ms).cpu()]
    launches = read_counts()
    return (statistics.mean(losses[-CONV_STEPS // 4:]), losses, launches)


def phase_convergence(dev) -> dict:
    """Oktopk tracks dense SGD on the teacher task on the card: the mean
    loss of the last quarter under 1.10 x dense's, both falling, K1 and
    the compaction launched on the oktopk run. Returns its launches."""
    t0 = time.perf_counter()
    dense, dense_curve, _ = conv_final_loss(dev, "dense")
    oktopk, oktopk_curve, launches = conv_final_loss(dev, "oktopk")
    secs = time.perf_counter() - t0
    assert_launched(launches, SPARSE_KERNELS, "convergence")
    if not (dense_curve[-1] < dense_curve[0]
            and oktopk_curve[-1] < oktopk_curve[0]):
        raise AssertionError(f"convergence: a loss did not fall: dense "
                             f"{dense_curve[0]} -> {dense_curve[-1]}, "
                             f"oktopk {oktopk_curve[0]} -> "
                             f"{oktopk_curve[-1]}")
    if not math.isfinite(oktopk) or not oktopk < CONV_LIMIT * dense:
        raise AssertionError(f"convergence: oktopk {oktopk} vs dense "
                             f"{dense} (limit {CONV_LIMIT}x)")
    emit({"phase": "convergence", "model": "mnistnet", "workers": 8,
          "steps": CONV_STEPS, "dense_final": dense,
          "oktopk_final": oktopk, "ratio": oktopk / dense,
          "limit": CONV_LIMIT, "dense_first_last": [dense_curve[0],
                                                    dense_curve[-1]],
          "oktopk_first_last": [oktopk_curve[0], oktopk_curve[-1]],
          "launches": launches, "seconds": secs})
    return launches


N_BERT = 110106428            # BERT-base's flat parameter count
N_LSTMAN4 = 54791168          # DeepSpeech (lstman4, 5 x 800)'s


def combine_inputs(n: int, dev, wire_dtype: str, P: int = 4,
                   seed: int = SEED + 18):
    """oktopk's combine inputs at P stacked workers, d = 0.01, as its step
    hands them over: acc [P, n] (a normal draw, sigma 0.01) and lt [P]
    (about 1% of each row); phase (a)'s received rows, the stacked
    all_to_all's transposed view of each worker's pack at its lt over the
    equal regions, rounded through the wire; phase (b)'s gathered rows,
    each owner's select from the scatter of those (about 1% of n in all)
    through the wire, the all_gather's broadcast view, divided by P as
    oktopk divides them; the indices the broadcast view itself. Returns
    ({acc, lt, r_vals, r_idx, gv, gi}, cfg)."""
    import torch
    from oktopk_tpu_torch.collectives.state import equal_boundaries
    from oktopk_tpu_torch.collectives.wire import wire_round
    from oktopk_tpu_torch.config import OkTopkConfig
    from oktopk_tpu_torch.ops import combine, compaction

    cfg = OkTopkConfig(n=n, num_workers=P, density=0.01,
                       wire_dtype=wire_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    acc = 0.01 * torch.randn((P, n), generator=gen, device=dev)
    lt = 0.02576 * (1.0 + 0.01 * torch.arange(P, dtype=torch.float32,
                                              device=dev))
    bnd = equal_boundaries(n, P, dev).expand(P, P + 1)
    s_vals, s_idx, _ = compaction.pack_rows(acc, lt, bnd, P, cfg.cap_pair)
    r_vals = wire_round(s_vals, cfg).transpose(0, 1)
    r_idx = s_idx.transpose(0, 1)
    reduced = combine.scatter_rows_plain(n, r_vals, r_idx)
    gvals, gidx, _ = compaction.select_rows(reduced, 1.15 * lt,
                                            cfg.cap_gather)
    gv = wire_round(gvals, cfg).expand(P, *gvals.shape) / P
    gi = gidx.expand(P, *gidx.shape)
    return dict(acc=acc, lt=lt, r_vals=r_vals, r_idx=r_idx, gv=gv,
                gi=gi), cfg


def storage_bytes(*ts) -> int:
    """Bytes of the tensors' storages (a broadcast or transposed view
    counts what it reads once)."""
    return sum(t.untyped_storage().nbytes() for t in ts)


def cb_launches(fn) -> dict:
    """{kernel: launches} of the ``cb_*`` kernels one call puts on the
    card (one profiled call, after a warm one)."""
    import torch
    fn()
    torch.cuda.synchronize()
    counts, _ = profile_window(fn, 1)
    out = {}
    for k, v in counts.items():
        bare = k[5:] if k.startswith("void ") else k
        if bare.startswith("cb_"):
            out[bare] = out.get(bare, 0) + v
    return out


def phase_combine(dev) -> None:
    """The combine kernels against their plain versions and timed, at
    BERT-base's n, VGG-16's (one bucket, the benchmark's VGG cell) and
    VGG-16's two bucket n's, both wires."""
    import torch
    from oktopk_tpu_torch.ops import combine

    sizes = [("bert", N_BERT), ("vgg16", N_VGG16)] + [
        (f"vgg16_b{b}", nb) for b, nb in enumerate(vgg16_bucket_sizes())]
    for prefix, n in sizes:
        for wire_dtype in ("bfloat16", "float32"):
            t, cfg = combine_inputs(n, dev, wire_dtype)
            W, R = t["r_vals"].shape[:2]
            acc, lt = t["acc"], t["lt"]
            reduced = combine.scatter_rows(n, t["r_vals"], t["r_idx"])
            result = combine.scatter_rows(n, t["gv"], t["gi"])
            plain_red = combine.scatter_rows_plain(n, t["r_vals"],
                                                   t["r_idx"])
            plain_res = combine.scatter_rows_plain(n, t["gv"], t["gi"])
            tag = f"{prefix} {wire_dtype}"
            bits_equal(reduced, plain_red, f"{tag}: scatter_a")
            bits_equal(result, plain_res, f"{tag}: scatter_b")
            bits_equal(
                combine.residual_after_winners(acc, lt, reduced, result,
                                               cfg),
                combine.residual_after_winners_plain(acc, lt, plain_red,
                                                     plain_res, cfg),
                f"{tag}: residual")
            del plain_red, plain_res
            bf16 = wire_dtype != "float32"
            dense = 4 * W * n
            forms = {
                "scatter_a": (
                    lambda: combine.scatter_rows(n, t["r_vals"], t["r_idx"]),
                    lambda: combine.scatter_rows_plain(n, t["r_vals"],
                                                       t["r_idx"]),
                    dense + storage_bytes(t["r_vals"], t["r_idx"]),
                    {"cb_scatter": R}),
                "scatter_b": (
                    lambda: combine.scatter_rows(n, t["gv"], t["gi"]),
                    lambda: combine.scatter_rows_plain(n, t["gv"], t["gi"]),
                    dense + storage_bytes(t["gv"], t["gi"]),
                    {"cb_scatter": R}),
                "residual": (
                    lambda: combine.residual_after_winners(
                        acc, lt, reduced, result, cfg),
                    lambda: combine.residual_after_winners_plain(
                        acc, lt, reduced, result, cfg),
                    (4 if bf16 else 3) * dense + 4 * W,
                    {f"cb_residual<{'true' if bf16 else 'false'}>": 1}),
            }
            recs = {}
            for form, (kern, plain, nbytes, expect) in forms.items():
                got = cb_launches(kern)
                if got != expect:
                    raise AssertionError(f"{tag} {form}: cb_ launches {got},"
                                         f" expected {expect}")
                rec = {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                       "kernel": timing(kern), "plain": timing(plain)}
                recs[form] = rec
                emit({"phase": "combine", "form": f"{prefix}_{form}",
                      "wire": wire_dtype, "n": n, "W": W, "R": R,
                      "cap": (t["r_vals"] if form == "scatter_a"
                              else t["gv"]).shape[2], "bit_equal": True,
                      **rec})
            total = {k: sum(r["kernel"][k] for r in recs.values())
                     for k in ("device_ms", "call_ms")}
            emit({"phase": "combine_total", "size": prefix, "n": n,
                  "wire": wire_dtype, **total,
                  "bound_ms": sum(r["bound_ms"] for r in recs.values()),
                  "plain_device_ms": sum(r["plain"]["device_ms"]
                                         for r in recs.values())})
            del t, acc, lt, reduced, result, forms
            torch.cuda.empty_cache()


def phase_big_kernels(dev, phase: str, prefix: str, n: int, density: float,
                      t: float, seed: int, P: int = 4, sweep: bool = True):
    """K1 and the compaction's two oktopk forms at a model's flat size n
    and P workers, on rows of [P, n] buffers (row P-1: its first byte
    lies 4·(P-1)·n bytes into the buffer), held bit-equal to their plain
    versions and timed like the VGG-16 forms: the sweep (unless ``sweep``
    is False: K1's shape does not depend on P); phase (a)'s pack, R = P,
    cap_pair, on its acc at about ``density`` (|x| >= ``t`` of a normal
    draw); phase (b)'s select, R = 1, cap_exact, on a reduced row nonzero
    in one of P parts. Forms ``{prefix}_sweep``, ``{prefix}_pack_a``,
    ``{prefix}_select_b``."""
    import torch
    from oktopk_tpu_torch.config import OkTopkConfig
    from oktopk_tpu_torch.ops import compaction, fused_select

    if P not in (2, 4):
        raise ValueError(f"no region bounds for P = {P}")
    cfg = OkTopkConfig(n=n, num_workers=P, density=density)
    gen = torch.Generator(device=dev).manual_seed(seed)
    gbuf = torch.randn((P, n), generator=gen, device=dev)
    rbuf = 0.05 * torch.randn((P, n), generator=gen, device=dev)
    g, r = gbuf[P - 1], rbuf[P - 1]
    tt = torch.full((), t, dtype=torch.float32, device=dev)
    tp = tt * 1.25
    # off the 1024-element block grid, as region_bounds' four
    bnd = (region_bounds(n, dev) if P == 4 else torch.tensor(
        [0, n // 2 + 517, n], dtype=torch.int32, device=dev))
    st = fused_select.fused_select_stage(g, r, tt, tp)
    ref = fused_select.fused_select_plain(g, r, tt, tp)
    sweep_form, pack, select = (f"{prefix}_{f}" for f in (
        "sweep", "pack_a", "select_b"))
    err = {sweep_form: max(bits_equal(getattr(st, f), getattr(ref, f),
                                      f"{sweep_form}: {f}")
                           for f in ("acc", "local_count", "probe_count",
                                     "hist"))}
    del ref
    acc = st.acc
    xb, tb = phase_b_input(n, cfg.cap_exact, dev, P)
    forms = {
        sweep_form: {
            "kernel": lambda: fused_select.fused_select_stage(g, r, tt, tp),
            "plain": lambda: fused_select.fused_select_plain(g, r, tt, tp),
            "expect": K1_LAUNCHES,
            "bound_ms": (12 * n + 8 + 4 * 258) / HBM_BYTES_PER_S * 1e3},
        pack: {
            "R": P, "cap": cfg.cap_pair,
            "kernel": lambda: fused_select.fused_pack_finalize(
                st, bnd, P, cfg.cap_pair),
            "plain": lambda: compaction.pack_by_region_plain(
                acc, tt, bnd, P, cfg.cap_pair),
            "library": lambda: library_call(acc, tt),
            "expect": COMPACTION_LAUNCHES,
            "bound_ms": compaction_bound_ms(n, P, cfg.cap_pair, True)},
        select: {
            "R": 1, "cap": cfg.cap_exact,
            "kernel": lambda: compaction.select_by_threshold(
                xb, tb, cfg.cap_exact),
            "plain": lambda: compaction.select_by_threshold_plain(
                xb, tb, cfg.cap_exact),
            "library": lambda: library_call(xb, tb),
            "expect": COMPACTION_LAUNCHES,
            "bound_ms": compaction_bound_ms(n, 1, cfg.cap_exact, False)},
    }
    for nm in (pack, select):
        err[nm] = triples_equal(forms[nm]["kernel"](), forms[nm]["plain"](),
                                nm)
    if not sweep:
        del forms[sweep_form]
    torch.cuda.synchronize()
    emit({"phase": phase, "n": n, "P": P, "density": density, "k": cfg.k,
          "local_count": int(st.local_count),
          "survivors_b": int((xb.abs() >= tb).sum()), "bit_equal": True,
          "max_abs_err": err})
    timings = {}
    for nm, f in forms.items():
        rec = {k: v for k, v in f.items() if k in ("R", "cap", "bound_ms")}
        rec["kernel"] = timing(f["kernel"], f["expect"])
        for which in ("plain", "library"):
            if which in f:
                rec[which] = timing(f[which])
        timings[nm] = rec
        emit({"phase": "kernel_times", "form": nm, "n": n, **rec})
    del gbuf, rbuf, st, acc, xb
    torch.cuda.empty_cache()
    return timings, err


def bert_tiny_weights(seed: int):
    """A ``bert_tiny`` state_dict (dropout 0) drawn on the CPU."""
    import torch
    from oktopk_tpu_torch.models import create_model
    m = create_model("bert_tiny", dropout=0.0)
    m.init_weights(torch.Generator().manual_seed(seed))
    return m.state_dict()


def phase_bert_parity(dev):
    """``bert_tiny`` with dropout 0.1 from the same weights, the same
    synthetic batch (padded attention mask) and the same dropout key on
    the card and on the CPU: every site's mask bit-equal (the threefry
    kernel against its plain version), then logits (rtol 1e-4, atol 2e-5
    of the largest), loss (rtol 1e-5) and the flat gradient in JAX leaf
    order (atol 2e-5 of the largest) agree, TF32 off; then three oktopk
    steps, P = 4, cadence 2 (exact, predicted, exact), from the same
    weights, each worker's masks from the Trainer's key chain: losses
    finite and within rtol 1e-5, and where both selected the same
    elements (the nonzeros of the reduced gradient) the volumes equal."""
    import numpy as np
    import torch
    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
    from oktopk_tpu_torch.data import synthetic_batch
    from oktopk_tpu_torch.models import create_model
    from oktopk_tpu_torch.models.layout import to_jax_layout
    from oktopk_tpu_torch.ops import prng
    from oktopk_tpu_torch.train.losses import bert_pretrain_loss
    from oktopk_tpu_torch.train.trainer import Trainer

    sd = bert_tiny_weights(SEED)
    key = prng.fold_in(prng.prng_key(SEED), 11)
    rng = np.random.RandomState(SEED)
    batches = [synthetic_batch("bert_tiny", 16, rng) for _ in range(4)]
    for b in batches:
        b["attention_mask"][1::3, 20:] = 0
    b = batches[0]
    out = {}
    for where in ("cpu", dev):
        m = create_model("bert_tiny")
        m.load_state_dict(sd)
        m = m.to(where)
        t = {k: torch.from_numpy(v).to(where) for k, v in b.items()}
        mlm, nsp = m(t["input_ids"], t["token_type_ids"],
                     t["attention_mask"], train=True, rng=key)
        loss = bert_pretrain_loss(mlm, nsp, t["mlm_labels"],
                                  t["nsp_labels"])[0]
        loss.backward()
        grad = torch.cat([to_jax_layout(p.grad, lay).reshape(-1)
                          for _, p, lay in m.jax_leaves()])
        out[str(where)] = [x.detach().cpu() for x in (mlm, nsp, loss, grad)]
    (c_mlm, c_nsp, c_loss, c_grad), (g_mlm, g_nsp, g_loss, g_grad) = (
        out["cpu"], out[str(dev)])
    bs, seq = b["input_ids"].shape
    hidden = (bs, seq, m.cfg.hidden_size)
    sites = site_masks_equal(
        m.site_hashes, key, [hidden] + [(1, 1, seq, seq), hidden, hidden]
        * m.cfg.num_layers, 1.0 - m.cfg.dropout, dev)
    errs = {}
    for nm, a, w, rtol, atol in (
            ("mlm_logits", g_mlm, c_mlm, 1e-4, 2e-5),
            ("nsp_logits", g_nsp, c_nsp, 1e-4, 2e-5),
            ("flat_grad", g_grad, c_grad, 0.0, 2e-5)):
        scale = float(w.abs().max())
        errs[nm] = float((a - w).abs().max())
        if not torch.allclose(a, w, rtol=rtol, atol=atol * scale):
            raise AssertionError(f"bert_parity {nm}: max abs err "
                                 f"{errs[nm]} (largest {scale})")
    errs["loss"] = abs(float(g_loss) - float(c_loss))
    if errs["loss"] > 1e-5 * abs(float(c_loss)):
        raise AssertionError(f"bert_parity loss: {float(g_loss)} vs "
                             f"{float(c_loss)}")

    algo = OkTopkConfig(warmup_steps=0, local_recompute_every=2,
                        global_recompute_every=2, repartition_every=2)
    cfg = TrainConfig(dnn="bert_tiny", batch_size=4, lr=4e-4,
                      density=0.02, num_workers=4, seed=SEED,
                      total_steps=10, warmup_proportion=0.1)
    trainers, selected = {}, {}
    for where in ("cpu", dev):
        tr = Trainer(cfg, algo_cfg=algo, device=where)
        tr.model.load_state_dict(sd)
        trainers[str(where)] = tr

        def step(flat, inner=tr.grad_step, key=str(where)):
            reduced, metrics, skip = inner(flat)
            selected[key] = (reduced != 0).cpu()
            return reduced, metrics, skip

        tr.grad_step = step
    steps = []
    for s, bt in enumerate(batches[1:]):
        ms = {w: tr.train_step(bt) for w, tr in trainers.items()}
        lc, lg = float(ms["cpu"]["loss"]), float(ms[str(dev)]["loss"])
        if not (math.isfinite(lc) and math.isfinite(lg)):
            raise AssertionError(f"bert_parity step {s}: loss {lg} / {lc}")
        if abs(lg - lc) > 1e-5 * abs(lc):
            raise AssertionError(f"bert_parity step {s}: loss {lg} vs {lc}")
        differ = int((selected["cpu"] != selected[str(dev)]).sum())
        same = differ == 0
        vc, vg = (float(ms[w]["comm_volume"]) for w in ("cpu", str(dev)))
        if same and vc != vg:
            raise AssertionError(f"bert_parity step {s}: selections agree, "
                                 f"volumes {vg} vs {vc}")
        steps.append({"step": s, "loss_card": lg, "loss_cpu": lc,
                      "volume_card": vg, "volume_cpu": vc,
                      "selections_agree": same,
                      "selected_elements_differ": differ})
    pdiff = max(float((a.detach().cpu() - b.detach()).abs().max())
                for a, b in zip(trainers[str(dev)].params,
                                trainers["cpu"].params))
    emit({"phase": "bert_parity", "model": "bert_tiny", "dropout": 0.1,
          "site_masks_bit_equal": sites,
          "n": trainers["cpu"].algo_cfg.n, "max_abs_err": errs,
          "steps": steps, "params_max_abs_diff_after_3_steps": pdiff})
    return errs


def repartition_rowwise(abs_acc, local_thresh, cfg, comm):
    """``collectives/oktopk.py::_repartition`` as it was, with PyTorch's
    row-wise scan (the yardstick for the flattened one)."""
    import torch
    P, n = cfg.num_workers, cfg.n
    mask = abs_acc >= local_thresh[:, None]
    csum = torch.cumsum(mask, 1, dtype=torch.int32)
    total = csum[:, -1]
    steps = torch.arange(1, P, dtype=torch.int32, device=abs_acc.device)
    targets = (steps[None, :] * total[:, None]).to(torch.float32) / P
    interior = torch.searchsorted(csum.to(torch.float32), targets,
                                  side="left").to(torch.float32)
    avg = comm.psum(interior) / P
    interior_i = torch.clamp(torch.round(avg).to(torch.int32), 0, n)
    interior_i = torch.sort(interior_i, dim=1).values
    zeros = torch.zeros((abs_acc.shape[0], 1), dtype=torch.int32,
                        device=abs_acc.device)
    return torch.cat([zeros, interior_i, zeros + n], dim=1)


class StepClock:
    """CUDA events around the trainer's collective: each step splits into
    forward/backward with the flat-gradient copy, the collective, and the
    optimizer update."""

    def __init__(self, trainer):
        import torch
        self.torch, self.marks = torch, {}
        self.inner = inner = trainer.grad_step

        def step(flat):
            self.mark("collective_start")
            out = inner(flat)
            self.mark("collective_end")
            return out

        trainer.grad_step = step

    def mark(self, name):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks[name] = ev

    def split(self):
        m = self.marks
        return {"fwd_bwd_ms": m["start"].elapsed_time(m["collective_start"]),
                "collective_ms": m["collective_start"].elapsed_time(
                    m["collective_end"]),
                "optimizer_ms": m["collective_end"].elapsed_time(m["end"]),
                "device_ms": m["start"].elapsed_time(m["end"])}


def phase_bert_trainer(dev, steps: int = 5):
    """The slice at full width through the CLI's own
    ``main_bert.build_trainer``: BERT-base (n = 110,106,428), P = 4
    workers stacked on the card, bs 8 per worker (global batch 32), seq
    128, dropout 0.1, oktopk at d = 0.01 with ``_bert_algo_cfg`` (no dense
    warmup: step 1 is the exact recompute and the repartition, steps 2-5
    predicted), BertAdam; launch counters set to 0 just before the steps
    and read just after. Then ``_repartition`` at this size, flattened
    scan against the row-wise one."""
    import torch
    from oktopk_tpu_torch.collectives.oktopk import _repartition
    from oktopk_tpu_torch.train import main_bert

    args = main_bert.parse_args(["--model", "bert_base", "--num-workers",
                                 "4", "--num-minibatches", str(steps),
                                 "--seed", str(SEED)])
    t0 = time.perf_counter()
    trainer, data = main_bert.build_trainer(args)
    build_s = time.perf_counter() - t0
    n = trainer.algo_cfg.n
    if n != N_BERT:
        raise AssertionError(f"BERT-base has {n} parameters")
    batches = [next(data) for _ in range(steps)]
    clock = StepClock(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    recs = []
    for s, b in enumerate(batches):
        clock.mark("start")
        t0 = time.perf_counter()
        m = trainer.train_step(b)
        clock.mark("end")
        torch.cuda.synchronize()
        rec = {k: float(v) for k, v in m.items()}
        rec.update(step=s + 1, ms=(time.perf_counter() - t0) * 1e3,
                   **clock.split())
        recs.append(rec)
        emit({"phase": "bert_trainer", **rec})
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    assert_launched(launches, DROPOUT_KERNELS, "bert_trainer")
    for r in recs:
        for k in ("loss", "mlm_loss", "nsp_loss"):
            if not math.isfinite(r[k]):
                raise AssertionError(f"bert_trainer step {r['step']}: {k} "
                                     f"{r[k]}")
    for p in trainer.params:
        if not bool(torch.isfinite(p).all()):
            raise AssertionError("bert_trainer: non-finite parameter")

    # the repartition at this size, on the last step's flat gradient
    st = clock.inner.states[0]
    abs_acc = (trainer.flat + st.residual).abs()
    lt = st.local_threshold
    cfg, comm = trainer.algo_cfg, trainer.comm
    new = _repartition(abs_acc, lt, cfg, comm)
    old = repartition_rowwise(abs_acc, lt, cfg, comm)
    bits_equal(new, old, "repartition: flattened vs row-wise scan")
    rep = {"flattened_ms": cuda_time_ms(
               lambda: _repartition(abs_acc, lt, cfg, comm), iters=5,
               warmup=1),
           "rowwise_ms": cuda_time_ms(
               lambda: repartition_rowwise(abs_acc, lt, cfg, comm), iters=5,
               warmup=1),
           "boundaries": [int(x) for x in new[0]]}
    del abs_acc
    sparse = recs[1:]
    summary = {
        "model": "bert_base", "n": n, "workers": 4, "global_batch": 32,
        "seq": args.max_seq_length, "density": args.density,
        "k": cfg.k, "steps": len(recs), "build_s": build_s,
        "step_ms": [r["ms"] for r in recs],
        "median_step_ms": statistics.median(r["ms"] for r in recs),
        "median_predicted_step_ms": statistics.median(r["ms"]
                                                      for r in sparse),
        "median_collective_ms": statistics.median(r["collective_ms"]
                                                  for r in recs),
        "median_fwd_bwd_ms": statistics.median(r["fwd_bwd_ms"]
                                               for r in recs),
        "median_optimizer_ms": statistics.median(r["optimizer_ms"]
                                                 for r in recs),
        "losses": [r["loss"] for r in recs],
        "mlm_losses": [r["mlm_loss"] for r in recs],
        "nsp_losses": [r["nsp_loss"] for r in recs],
        "volume": [r["comm_volume"] for r in recs],
        "local_k": [r["local_k"] for r in recs],
        "global_k": [r["global_k"] for r in recs],
        "wire_bytes": [r["wire_bytes"] for r in recs],
        "max_memory_allocated_gb": peak / 1e9,
        "launches": launches,
        "launches_per_step": {k: v / len(recs) for k, v in launches.items()},
        "repartition": rep}
    emit({"phase": "bert_trainer_summary", **summary})
    del trainer
    torch.cuda.empty_cache()
    return launches


# ---- the pipeline slice: BERT-base over a data x pipe grid (item 16a) ----

PIPELINE_BUDGET_S = 90.0      # the pipeline phase's own budget
N_PP_STAGE = 42527232         # a BERT-base stage bucket at pp = 2 (6 layers)
N_PP_SHARED = 25051964        # its shared bucket (embeddings, pooler, heads)
PIPELINE_ARGV = ["--model", "bert_base", "--pipeline-stages", "2",
                 "--num-workers", "4", "--num-microbatches", "4",
                 "--batch-size", "8", "--compressor", "oktopk",
                 "--density", "0.01"]
PIPELINE_STEPS = 5            # the exact step, then four steady ones
PIPE_TINY_ARGV = ["--model", "bert_tiny", "--pipeline-stages", "2",
                  "--num-workers", "4", "--num-microbatches", "2",
                  "--batch-size", "2", "--density", "0.02"]
PIPE_TINY_ULPS = 64


def pipeline_params_digest(staged) -> dict:
    """sha1 of each stage's and of the shared parameters, in state_dict
    order."""
    import hashlib
    out = {}
    for k, v in staged.state_dict().items():
        part = k.split(".")[1] if k.startswith("stages.") else "shared"
        h = out.setdefault(f"stage{part}" if part != "shared" else part,
                           hashlib.sha1())
        h.update(v.detach().cpu().numpy().tobytes())
    return {k: h.hexdigest() for k, h in out.items()}


def pipeline_run(dev, argv, steps: int, profile: bool = False,
                 digests: bool = False):
    """``steps`` steps of the pipeline path built by the CLI's own
    ``main_bert.build_pipeline``, launch counters set to 0 just before
    and read just after: per-step metrics and host ms (with ``digests``
    each step's parameter digests, outside the timed span), the
    launches, peak memory, the parameters' digests, and with ``profile``
    one more step under the profiler (device busy ms and launches)."""
    import torch
    from oktopk_tpu_torch.train import main_bert

    args = main_bert.parse_args(argv + ["--num-minibatches", str(steps),
                                        "--seed", str(SEED), "--device",
                                        str(dev)])
    t0 = time.perf_counter()
    run = main_bert.build_pipeline(args)
    build_s = time.perf_counter() - t0
    batches = [next(run.data) for _ in range(steps + 1)]
    keys = [run.next_key() for _ in range(steps + 1)]
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    recs = []
    for s in range(steps):
        t0 = time.perf_counter()
        m = run.step(batches[s], keys[s])
        if cuda:
            torch.cuda.synchronize()
        recs.append({**{k: float(v) for k, v in m.items()}, "step": s + 1,
                     "ms": (time.perf_counter() - t0) * 1e3})
        if digests:
            recs[-1]["digest"] = pipeline_params_digest(run.staged)
    launches = read_counts()
    out = {"run": run, "recs": recs, "launches": launches,
           "build_s": build_s, "digest": pipeline_params_digest(run.staged),
           "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                       if cuda else None)}
    if profile:
        counts, by_op = profile_window(
            lambda: run.step(batches[steps], keys[steps]), 1)
        out["profiled"] = {"busy_ms": sum(by_op.values()),
                           "launches": sum(counts.values()),
                           "top": dict(sorted(by_op.items(),
                                              key=lambda kv: -kv[1])[:8])}
    for r in recs:
        if not math.isfinite(r["loss"]):
            raise AssertionError(f"pipeline step {r['step']}: loss "
                                 f"{r['loss']}")
    return out


def embedding_repeats(dev, reps: int = 8) -> dict:
    """The lookup gradients of a pipeline data row's 32 x 128 ids, ``reps``
    times from the same inputs: the word table's (random ids, the [MASK]
    id every 7th) and the token-type table's (every id 0: one segment of
    4,096). How many distinct results CUDA's own embedding backward
    gives, and the port's ``embedding_grad`` (chunks of
    ``EMBED_GRAD_CHUNK``), which must give one."""
    import hashlib

    import torch
    from oktopk_tpu_torch.models.layers import embedding_grad
    gen = torch.Generator(device=dev).manual_seed(SEED)
    word = torch.randint(0, N_VOCAB_BASE, (32, 128), generator=gen,
                         device=dev)
    word[:, ::7] = 103
    g = torch.randn((32, 128, 768), generator=gen, device=dev)

    def distinct(fn):
        return len({hashlib.sha1(fn().cpu().numpy().tobytes()).hexdigest()
                    for _ in range(reps)})

    out = {"reps": reps}
    for name, ids, rows in (("word", word, N_VOCAB_BASE),
                            ("token_type", torch.zeros_like(word), 2)):
        out[name] = {
            "torch_distinct": distinct(
                lambda: torch.ops.aten.embedding_dense_backward(
                    g, ids, rows, -1, False)),
            "port_distinct": distinct(lambda: embedding_grad(g, ids, rows))}
        if out[name]["port_distinct"] != 1:
            raise AssertionError(f"embedding_grad does not repeat: {out}")
    return out


def pipeline_thresholds(run) -> dict:
    """Each bucket's local and global thresholds, [W_d] rows."""
    states, shared = run.step.sstates
    out = {f"stage{s}": st for s, st in zip(run.staged.stage_ids, states)}
    out["shared"] = shared
    return {b: {f: getattr(st, f).detach().cpu() for f in
                ("local_threshold", "global_threshold")}
            for b, st in out.items()}


def phase_pipeline(dev) -> dict:
    """The pipeline slice at full width through ``main_bert``'s pipeline
    path: BERT-base (n = 110,106,428) over a data x pipe grid of dp = 2 x
    pp = 2 stacked on the card (6 layers a stage), M = 4 microbatches of
    8, seq 128, dropout 0.1, each stage bucket (42,527,232) and the
    shared bucket (25,051,964) through oktopk at d = 0.01 over its data
    group, BertAdam on each: five steps (the exact recompute, then four
    steady ones), counters set to 0 just before and read just after (K1,
    the compaction and threefry launched), per-step host ms, one profiled
    step (device busy ms), peak memory; the same five steps with
    ``--remat``, losses, volumes and parameters bit-identical; two
    ``--compressor dense`` steps; one ``bert_tiny`` step on the card and
    on the CPU from one seed: losses within rtol 1e-5, each bucket's
    thresholds within ``PIPE_TINY_ULPS`` ulps; first, the word table's
    lookup gradient at a data row's 32 x 128 ids repeated
    (``embedding_repeats``). Its own budget,
    ``PIPELINE_BUDGET_S``. Returns the five steps' launches."""
    import torch
    t_phase = time.perf_counter()
    embed = embedding_repeats(dev)
    main = pipeline_run(dev, PIPELINE_ARGV, PIPELINE_STEPS, profile=True,
                        digests=True)
    grid, step = main["run"].grid, main["run"].step
    if (grid.dp, grid.pp) != (2, 2):
        raise AssertionError(f"pipeline grid {grid.dp} x {grid.pp}")
    sizes = [b.n for b in step.stage_buckets] + [step.shared_bucket.n]
    if sizes != [N_PP_STAGE, N_PP_STAGE, N_PP_SHARED]:
        raise AssertionError(f"pipeline bucket sizes {sizes}")
    del step
    assert_launched(main["launches"], DROPOUT_KERNELS, "pipeline")
    profiled = main.pop("profiled")
    del main["run"]
    torch.cuda.empty_cache()
    remat = pipeline_run(dev, PIPELINE_ARGV + ["--remat"], PIPELINE_STEPS,
                         digests=True)
    del remat["run"]
    torch.cuda.empty_cache()
    same = {key: [r[key] for r in main["recs"]] == [r[key] for r in
                                                      remat["recs"]]
            for key in ("loss", "comm_volume", "digest")}
    if not all(same.values()):
        # which step and bucket parted first, and whether a second run
        # without --remat parts from the first too (run to run)
        again = pipeline_run(dev, PIPELINE_ARGV, PIPELINE_STEPS,
                             digests=True)
        del again["run"]
        torch.cuda.empty_cache()

        def first(a, b):
            for r, w in zip(a["recs"], b["recs"]):
                bad = [k for k in r["digest"] if r["digest"][k] !=
                       w["digest"][k]]
                if bad or r["loss"] != w["loss"]:
                    return {"step": r["step"], "buckets": bad,
                            "loss": [r["loss"], w["loss"]]}
            return None

        emit({"phase": "pipeline_remat_mismatch", "equal": same,
              "remat_vs_plain": first(remat, main),
              "plain_vs_plain": first(again, main)})
        raise AssertionError(f"pipeline --remat: not bit-identical {same}")
    dense = pipeline_run(dev, [a if a != "oktopk" else "dense"
                               for a in PIPELINE_ARGV], 2)
    del dense["run"]
    torch.cuda.empty_cache()
    tiny = {w: pipeline_run(w, PIPE_TINY_ARGV, 1) for w in (str(dev), "cpu")}
    lc, lg = tiny["cpu"]["recs"][0]["loss"], tiny[str(dev)]["recs"][0]["loss"]
    if abs(lg - lc) > 1e-5 * abs(lc):
        raise AssertionError(f"pipeline bert_tiny card vs CPU: loss {lg} vs "
                             f"{lc}")
    thr = {w: pipeline_thresholds(t["run"]) for w, t in tiny.items()}
    ulps = {b: {f: max_ulps(thr[str(dev)][b][f], thr["cpu"][b][f])
                for f in thr["cpu"][b]} for b in thr["cpu"]}
    worst = max(max(v.values()) for v in ulps.values())
    if worst > PIPE_TINY_ULPS:
        raise AssertionError(f"pipeline bert_tiny thresholds card vs CPU: "
                             f"{ulps} ulps")
    del tiny
    ms = [r["ms"] for r in main["recs"]]
    secs = time.perf_counter() - t_phase
    emit({"phase": "pipeline", "model": "bert_base", "n": N_BERT,
          "grid": "dp 2 x pp 2 stacked", "microbatches": 4,
          "microbatch": 8, "global_batch": 64, "seq": 128, "density": 0.01,
          "buckets": {"stage": N_PP_STAGE, "shared": N_PP_SHARED},
          "build_s": main["build_s"],
          "losses": [r["loss"] for r in main["recs"]],
          "comm_volume": [r["comm_volume"] for r in main["recs"]],
          "step_ms": ms, "steady_step_ms": spread(ms[1:]),
          "exact_step_ms": ms[0], "profiled_step": profiled,
          "max_memory_allocated_gb": main["peak_gb"],
          "launches": main["launches"],
          "launches_per_step": {k: v / PIPELINE_STEPS
                                for k, v in main["launches"].items()},
          "remat": {"bit_identical": True,
                    "step_ms": [r["ms"] for r in remat["recs"]],
                    "max_memory_allocated_gb": remat["peak_gb"]},
          "dense": {"losses": [r["loss"] for r in dense["recs"]],
                    "step_ms": [r["ms"] for r in dense["recs"]],
                    "launches": dense["launches"]},
          "tiny_card_vs_cpu": {"loss_card": lg, "loss_cpu": lc,
                               "threshold_ulps": ulps},
          "embedding_grad_repeats": embed,
          "seconds": secs})
    if secs > PIPELINE_BUDGET_S:
        raise AssertionError(f"pipeline took {secs:.1f} s of its "
                             f"{PIPELINE_BUDGET_S:.0f} s budget")
    return main["launches"]


# ---- sequence and tensor parallelism (item 16b) ---------------------------

SEQ_BUDGET_S = 90.0           # the seq_parallel phase's own budget
TP_BUDGET_S = 60.0            # the tensor_parallel phase's own budget
N_BERT_2048 = 111286076       # BERT-base with 2,048 position rows
N_TP_SHARD = 42499584         # a BERT-base tp shard at tp = 2
N_TP_SHARED = 25107260        # its shared bucket (replicated parameters)
SEQ_ARGV = ["--model", "bert_base", "--seq-shards", "2",
            "--seq-data-shards", "2", "--batch-size", "2", "--compressor",
            "oktopk", "--density", "0.01"]
SEQ_STEPS = 3                 # the exact step, then two steady ones
SEQ_TINY_ARGV = ["--model", "bert_tiny", "--seq-shards", "2",
                 "--seq-data-shards", "2", "--batch-size", "2",
                 "--density", "0.05"]
TINY_ULPS = 64
TP_STEPS = 3
TP_BATCH = 8                  # sequences a data row, seq 128


def seq_run(dev, argv, steps: int):
    """``steps`` steps of the seq path built by the CLI's own
    ``main_bert.build_seq``, launch counters set to 0 just before and read
    just after: per-step metrics, host ms and replica check, the
    launches and peak memory."""
    import torch
    from oktopk_tpu_torch.train import main_bert

    args = main_bert.parse_args(argv + ["--num-minibatches", str(steps),
                                        "--seed", str(SEED),
                                        "--device", str(dev)])
    t0 = time.perf_counter()
    run = main_bert.build_seq(args)
    build_s = time.perf_counter() - t0
    batches = [next(run.data) for _ in range(steps)]
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    recs = []
    for s in range(steps):
        t0 = time.perf_counter()
        m = run.step(batches[s])
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if not run.step.replicas_equal():
            raise AssertionError(f"seq step {s + 1}: the workers' copies "
                                 "differ")
        recs.append({**{k: float(v) for k, v in m.items()}, "step": s + 1,
                     "ms": ms})
        if not math.isfinite(recs[-1]["loss"]):
            raise AssertionError(f"seq step {s + 1}: loss {recs[-1]}")
    out = {"run": run, "recs": recs, "launches": read_counts(),
           "build_s": build_s,
           "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                       if cuda else None)}
    return out


def seq_memory(dev, flat, layout, cfg, sp: int, T: int = 2048,
               batch: int = 2) -> dict:
    """One fwd+bwd of a BERT-base data row of ``batch`` sequences of ``T``
    tokens at ``sp`` shards (dp = 1) from the flat parameters ``flat``
    (JAX order, ``layout``), the workers stacked on the card: the peak
    allocated, the parameter rows held before it, and the bytes autograd
    saves (the parameter rows left out), each also per worker."""
    import numpy as np
    import torch
    from oktopk_tpu_torch.data import synthetic_batch
    from oktopk_tpu_torch.parallel import bert_seq as bs

    grid = bs.make_seq_grid(sp)
    row = {k: torch.from_numpy(v).to(dev) for k, v in synthetic_batch(
        "bert_base", batch, np.random.RandomState(SEED), seq_len=T).items()}
    p = flat.expand(sp, -1).clone().requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    own = p.untyped_storage().data_ptr()
    saved = 0

    def pack(t):
        nonlocal saved
        if t.untyped_storage().data_ptr() != own:
            saved += t.numel() * t.element_size()
        return t

    t0 = time.perf_counter()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = bs._row_loss(p, layout, bs.shard_batch(row, grid), cfg, grid)
    loss.backward(torch.ones_like(loss))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    if not bool(torch.isfinite(p.grad).all()):
        raise AssertionError(f"seq memory sp={sp}: non-finite gradient")
    out = {"sp": sp, "T": T, "batch": batch, "fwd_bwd_ms": ms,
           "loss": float(loss[0].detach()), "peak_gb": peak / 1e9,
           "params_gb": before / 1e9,
           "peak_per_worker_gb": peak / sp / 1e9,
           "above_params_per_worker_gb": (peak - before) / sp / 1e9,
           "saved_per_worker_gb": saved / sp / 1e9}
    del p, loss, row
    torch.cuda.empty_cache()
    return out


def seq_thresholds(run) -> dict:
    """Each shard's sparse state's local and global thresholds."""
    return {s: {f: getattr(st, f).detach().cpu() for f in
                ("local_threshold", "global_threshold")}
            for s, st in enumerate(run.step.sstates)}


def tiny_card_vs_cpu(dev, runs, thresholds, what: str) -> dict:
    """Losses within rtol 1e-5 and thresholds within ``TINY_ULPS`` of a
    bert_tiny run on the card and on the CPU (``runs``: {where: recs})."""
    lc = [r["loss"] for r in runs["cpu"]]
    lg = [r["loss"] for r in runs[str(dev)]]
    for a, b in zip(lg, lc):
        if abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"{what} bert_tiny card vs CPU: loss "
                                 f"{lg} vs {lc}")
    ulps = {b: {f: max_ulps(thresholds[str(dev)][b][f],
                            thresholds["cpu"][b][f])
                for f in thresholds["cpu"][b]} for b in thresholds["cpu"]}
    worst = max(max(v.values()) for v in ulps.values())
    if worst > TINY_ULPS:
        raise AssertionError(f"{what} bert_tiny thresholds card vs CPU: "
                             f"{ulps} ulps")
    return {"loss_card": lg, "loss_cpu": lc, "threshold_ulps": ulps}


def phase_seq_parallel(dev) -> dict:
    """Item 16b-1 on the main path: ``main_bert --model bert_base
    --seq-shards 2 --seq-data-shards 2 --batch-size 2 --compressor oktopk
    --density 0.01`` through its ``build_seq``: a data x seq grid of 2 x 2
    stacked on the card, ring attention over the shards, each worker's
    whole gradient (n = 110,106,428; 111,286,076 at T = 2048) through
    oktopk over its data group, BertAdam, float32: three steps at T = 512
    and three at T = 2048 (the exact step, two steady), counters set to
    0 just before and read just after each (K1 and the compaction
    launched), host ms a step, peak memory, the four workers' copies
    bit-identical after every step; one fwd+bwd at T = 2048 at sp = 1 and
    sp = 4 (dp = 1), the stacked peak and its share a worker; one
    ``bert_tiny`` run card against CPU (losses within rtol 1e-5,
    thresholds within ``TINY_ULPS``) and its oktopk at the tiny n through
    ``card_vs_cpu`` (fields bit-equal); one ``--compute-dtype bfloat16``
    step. Its own budget, ``SEQ_BUDGET_S``. Returns the T = 512 run's
    launches."""
    import torch
    from oktopk_tpu_torch.config import OkTopkConfig
    t_phase = time.perf_counter()
    runs = {}
    for T, n in ((512, N_BERT), (2048, N_BERT_2048)):
        r = seq_run(dev, SEQ_ARGV + ["--max-seq-length", str(T)], SEQ_STEPS)
        run = r.pop("run")
        step = run.step
        if step.layout.n != n or (step.grid.dp, step.grid.sp) != (2, 2):
            raise AssertionError(f"seq T={T}: n {step.layout.n}, grid "
                                 f"{step.grid.dp} x {step.grid.sp}")
        if T == 2048:       # its trained weights feed the memory runs
            flat = step.params[0].detach()[0].clone()
            layout, cfg = step.layout, run.cfg
        del step, run
        torch.cuda.empty_cache()
        assert_launched(r["launches"], SPARSE_KERNELS, f"seq T={T}")
        if r["launches"]["threefry"]:
            raise AssertionError(f"seq T={T}: the deterministic forward "
                                 "launched threefry")
        runs[T] = r
    memory = [seq_memory(dev, flat, layout, cfg, sp) for sp in (1, 4)]
    del flat
    tiny = {w: seq_run(w, SEQ_TINY_ARGV, 2) for w in (str(dev), "cpu")}
    tiny_cmp = tiny_card_vs_cpu(
        dev, {w: t["recs"] for w, t in tiny.items()},
        {w: seq_thresholds(t["run"]) for w, t in tiny.items()}, "seq")
    n_tiny = tiny["cpu"]["run"].step.layout.n
    del tiny
    worst, _ = card_vs_cpu("oktopk", OkTopkConfig(
        n=n_tiny, num_workers=2, density=0.05, warmup_steps=0), 3, dev,
        TINY_ULPS)
    bf16 = seq_run(dev, SEQ_ARGV + ["--max-seq-length", "512",
                                    "--compute-dtype", "bfloat16"], 1)
    if bf16.pop("run").cfg.dtype != torch.bfloat16:
        raise AssertionError("seq --compute-dtype bfloat16 did not reach "
                             "the config")
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    rec = {"phase": "seq_parallel", "model": "bert_base",
           "grid": "dp 2 x sp 2 stacked", "batch_per_data_row": 2,
           "density": 0.01, "replicas_bit_identical": True}
    for T, r in runs.items():
        ms = [x["ms"] for x in r["recs"]]
        rec[f"T{T}"] = {"n": N_BERT if T == 512 else N_BERT_2048,
                        "build_s": r["build_s"],
                        "losses": [x["loss"] for x in r["recs"]],
                        "comm_volume": [x["comm_volume"] for x in r["recs"]],
                        "step_ms": ms, "exact_step_ms": ms[0],
                        "steady_step_ms": spread(ms[1:]),
                        "max_memory_allocated_gb": r["peak_gb"],
                        "launches": r["launches"],
                        "launches_per_step": {k: v / SEQ_STEPS for k, v in
                                              r["launches"].items()}}
    rec.update({
        "memory_T2048": memory,
        "memory_note": "one card holds every stacked worker: the T/P "
                       "claim shows in the share a worker, not the total",
        "tiny_card_vs_cpu": tiny_cmp, "tiny_oktopk_threshold_ulps": worst,
        "bf16": {"loss": bf16["recs"][0]["loss"],
                 "step_ms": bf16["recs"][0]["ms"],
                 "launches": bf16["launches"]},
        "seconds": secs})
    emit(rec)
    if secs > SEQ_BUDGET_S:
        raise AssertionError(f"seq_parallel took {secs:.1f} s of its "
                             f"{SEQ_BUDGET_S:.0f} s budget")
    return runs[512]["launches"]


def tp_batches(model: str, steps: int, seq: int):
    """Seeded synthetic MLM/NSP batches of 2 data rows of ``TP_BATCH``."""
    import numpy as np
    from oktopk_tpu_torch.data import synthetic_batch
    return [synthetic_batch(model, 2 * TP_BATCH, np.random.RandomState(
        SEED + s), seq_len=seq) for s in range(steps)]


def tp_run(dev, model: str, steps: int, density: float, seq: int):
    """``steps`` steps of ``build_tp_sparse_train_step`` (oktopk, BertAdam)
    over a dp 2 x tp 2 grid stacked on ``dev``, the single module's weights
    from the seed, counters set to 0 just before and read just after:
    per-step metrics and host ms, the shared copies checked after every
    step, the launches, peak memory, and the step-0 loss of the single
    module (no dropout) on the same rows."""
    import torch
    from oktopk_tpu_torch.config import OkTopkConfig
    from oktopk_tpu_torch.models.bert import BertConfig, BertForPreTraining
    from oktopk_tpu_torch.optim import BertAdam
    from oktopk_tpu_torch.parallel import bert_seq as bs
    from oktopk_tpu_torch.parallel import bert_tp as bt

    cfg = {"bert_base": BertConfig.base,
           "bert_tiny": BertConfig.tiny}[model](dropout=0.0)
    m = BertForPreTraining(cfg)
    m.init_weights(torch.Generator().manual_seed(SEED))
    t0 = time.perf_counter()
    step = bt.build_tp_sparse_train_step(
        cfg, bt.make_tp_grid(2, 2), *bt.split_tp(bs.jax_tree(m), 2),
        BertAdam(lr=2e-4, warmup=0.01, t_total=steps),
        OkTopkConfig(density=density, warmup_steps=0),
        compressor="oktopk", warmup=False, device=dev)
    build_s = time.perf_counter() - t0
    batches = tp_batches(model, steps, seq)
    m.to(dev)
    with torch.no_grad():
        ref = []
        for d in range(2):
            b = {k: torch.from_numpy(v[d * TP_BATCH:(d + 1) * TP_BATCH]
                                     ).to(dev)
                 for k, v in batches[0].items()}
            mlm, nsp = m(b["input_ids"], b["token_type_ids"],
                         b["attention_mask"], train=False)
            lab = b["mlm_labels"]
            mask = (lab >= 0).float()
            tok = torch.nn.functional.cross_entropy(
                mlm.flatten(0, 1), lab.clamp(min=0).long().flatten(),
                reduction="none").view(lab.shape)
            ref.append(float((tok * mask).sum() / mask.sum().clamp(min=1)
                             + torch.nn.functional.cross_entropy(
                                 nsp, b["nsp_labels"].long())))
    del m
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    recs = []
    for s in range(steps):
        t0 = time.perf_counter()
        met = step(batches[s])
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if not (step.shared_equal()
                and torch.equal(step.tp[0].detach(), step.tp[1].detach())):
            raise AssertionError(f"tp step {s + 1}: the shared copies or "
                                 "the data replicas differ")
        recs.append({**{k: float(v) for k, v in met.items()},
                     "step": s + 1, "ms": ms})
        if not math.isfinite(recs[-1]["loss"]):
            raise AssertionError(f"tp step {s + 1}: loss {recs[-1]}")
    return {"step": step, "recs": recs, "launches": read_counts(),
            "build_s": build_s, "single_module_loss": sum(ref) / 2,
            "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if cuda else None)}


def phase_tensor_parallel(dev) -> dict:
    """Item 16b-3 on the card: BERT-base over a data x model grid of 2 x 2
    stacked on the card, Megatron's two psums a layer,
    ``build_tp_sparse_train_step`` with oktopk at d = 0.01 on each
    worker's tp shard (n = 42,499,584) and its shared copy (25,107,260)
    over its data group, BertAdam, 8 sequences of 128 a data row: three
    steps, counters set to 0 just before and read just after (K1 and the
    compaction launched), host ms a step, peak memory, the shared copies
    bit-identical across model ranks and data rows and the tp shards
    across data rows after every step, the first loss against the single
    module's (rtol 1e-5); one ``bert_tiny`` run card against CPU (losses
    within rtol 1e-5, thresholds within ``TINY_ULPS``). Its own budget,
    ``TP_BUDGET_S``. Returns the BERT-base run's launches."""
    import torch
    t_phase = time.perf_counter()
    main = tp_run(dev, "bert_base", TP_STEPS, 0.01, 128)
    step = main.pop("step")
    if (step.tp_layout.n, step.shared_layout.n) != (N_TP_SHARD, N_TP_SHARED):
        raise AssertionError(f"tp buckets {step.tp_layout.n}, "
                             f"{step.shared_layout.n}")
    del step
    torch.cuda.empty_cache()
    assert_launched(main["launches"], SPARSE_KERNELS, "tensor_parallel")
    l0, ref = main["recs"][0]["loss"], main["single_module_loss"]
    if abs(l0 - ref) > 1e-5 * abs(ref):
        raise AssertionError(f"tp step-0 loss {l0} vs the single module's "
                             f"{ref}")
    tiny = {w: tp_run(w, "bert_tiny", 2, 0.05, 32) for w in (str(dev),
                                                            "cpu")}
    thr = {w: {f"{name}{m}": {f: getattr(st, f).detach().cpu() for f in
                              ("local_threshold", "global_threshold")}
               for name, states in zip(("tp", "shared"),
                                       t["step"].sstates)
               for m, st in enumerate(states)}
           for w, t in tiny.items()}
    tiny_cmp = tiny_card_vs_cpu(dev, {w: t["recs"] for w, t in tiny.items()},
                                thr, "tp")
    del tiny
    ms = [r["ms"] for r in main["recs"]]
    secs = time.perf_counter() - t_phase
    emit({"phase": "tensor_parallel", "model": "bert_base",
          "grid": "dp 2 x tp 2 stacked", "batch_per_data_row": TP_BATCH,
          "seq": 128, "density": 0.01,
          "buckets": {"tp_shard": N_TP_SHARD, "shared": N_TP_SHARED},
          "build_s": main["build_s"],
          "losses": [r["loss"] for r in main["recs"]],
          "single_module_loss_step0": ref,
          "comm_volume": [r["comm_volume"] for r in main["recs"]],
          "step_ms": ms, "exact_step_ms": ms[0],
          "steady_step_ms": spread(ms[1:]),
          "max_memory_allocated_gb": main["peak_gb"],
          "launches": main["launches"],
          "launches_per_step": {k: v / TP_STEPS
                                for k, v in main["launches"].items()},
          "shared_bit_identical": True, "tiny_card_vs_cpu": tiny_cmp,
          "seconds": secs})
    if secs > TP_BUDGET_S:
        raise AssertionError(f"tensor_parallel took {secs:.1f} s of its "
                             f"{TP_BUDGET_S:.0f} s budget")
    return main["launches"]


# ---- expert parallelism (item 16b-2) --------------------------------------

EXPERT_BUDGET_S = 60.0        # the expert_parallel phase's own budget
N_MOE_SHARD = 113338368       # a BERT-base expert shard: 2 of 4 experts
N_MOE_SHARED = 53474108       # its shared bucket (attention, gates, heads)
MOE_ARGV = ["--model", "bert_base", "--expert-shards", "2",
            "--expert-data-shards", "2", "--num-experts", "4",
            "--batch-size", "8", "--compressor", "oktopk", "--density",
            "0.01"]
MOE_STEPS = 3                 # the exact step, then two steady ones
MOE_TINY_ARGV = ["--model", "bert_tiny", "--expert-shards", "2",
                 "--expert-data-shards", "2", "--num-experts", "4",
                 "--batch-size", "2", "--density", "0.05"]


def moe_run(dev, argv, steps: int):
    """``steps`` steps of the expert path built by the CLI's own
    ``main_bert.build_moe``, launch counters set to 0 just before and read
    just after: per-step metrics and host ms, the shared copies and the
    expert shards checked after every step, the first step's routing,
    the launches and peak memory."""
    import torch
    from oktopk_tpu_torch.train import main_bert

    args = main_bert.parse_args(argv + ["--num-minibatches", str(steps),
                                        "--seed", str(SEED),
                                        "--device", str(dev)])
    t0 = time.perf_counter()
    run = main_bert.build_moe(args)
    build_s = time.perf_counter() - t0
    batches = [next(run.data) for _ in range(steps)]
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    recs, routing = [], None
    for s in range(steps):
        t0 = time.perf_counter()
        m = run.step(batches[s])
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if not (run.step.shared_equal() and run.step.experts_equal()):
            raise AssertionError(f"moe step {s + 1}: the shared copies or "
                                 "the expert shards' data replicas differ")
        if routing is None:
            r = run.step.routing
            routing = {"dropped_per_layer": r["dropped"].sum((1, 2))
                       .cpu().tolist(),
                       "load_per_layer": r["f"][0, 0].cpu().tolist()}
        recs.append({**{k: float(v) for k, v in m.items()}, "step": s + 1,
                     "ms": ms})
        if not math.isfinite(recs[-1]["loss"]):
            raise AssertionError(f"moe step {s + 1}: loss {recs[-1]}")
    return {"run": run, "recs": recs, "launches": read_counts(),
            "build_s": build_s, "routing": routing, "batch": batches[0],
            "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if cuda else None)}


def moe_oracle(dev, batch) -> dict:
    """The single-module oracle at BERT-base width: the seed's dense model
    tiled into 4 identical experts, the zero gate (every prob 1/4, so
    ``wo`` and ``bo`` times 4), capacity factor 4 (no overflow), no aux:
    the global loss over the 2 x 2 grid on ``batch`` against the single
    module's (no dropout) on the same batch."""
    import torch
    import torch.nn.functional as F
    from oktopk_tpu_torch.models.bert import BertConfig, BertForPreTraining
    from oktopk_tpu_torch.parallel import bert_moe as bm
    from oktopk_tpu_torch.parallel import bert_seq as bs

    E = 4
    cfg = BertConfig.base(dropout=0.0)
    m = BertForPreTraining(cfg)
    m.init_weights(torch.Generator().manual_seed(SEED))
    moe, shared = bm.experts_from_dense(bs.jax_tree(m), E)
    for lp in moe.values():
        lp["wo"], lp["bo"] = lp["wo"] * E, lp["bo"] * E
    moe = bs.tree_to_torch(bs.tree_to_numpy(moe), dev)
    shared = bs.tree_to_torch(bs.tree_to_numpy(shared), dev)
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    m.to(dev)
    with torch.no_grad():
        got = float(bm.build_moe_loss(
            cfg, bm.MoEConfig(num_experts=E, capacity_factor=float(E),
                              aux_weight=0.0),
            bm.make_moe_grid(2, 2))(moe, shared, b))
        mlm, nsp = m(b["input_ids"], b["token_type_ids"],
                     b["attention_mask"], train=False)
        lab = b["mlm_labels"]
        mask = (lab >= 0).float()
        tok = F.cross_entropy(mlm.flatten(0, 1), lab.clamp(min=0).long()
                              .flatten(), reduction="none").view(lab.shape)
        want = float((tok * mask).sum() / mask.sum().clamp(min=1)
                     + F.cross_entropy(nsp, b["nsp_labels"].long()))
    del m, moe, shared
    torch.cuda.empty_cache()
    if abs(got - want) > 1e-5 * abs(want):
        raise AssertionError(f"moe oracle loss {got} vs the single "
                             f"module's {want}")
    return {"loss": got, "single_module_loss": want,
            "rel_err": abs(got - want) / abs(want)}


def moe_thresholds(run) -> dict:
    """Each held expert rank's two sparse states' thresholds."""
    return {f"{name}{j}": {f: getattr(st, f).detach().cpu() for f in
                           ("local_threshold", "global_threshold")}
            for name, states in zip(("moe", "shared"), run.step.sstates)
            for j, st in enumerate(states)}


def phase_expert_parallel(dev) -> dict:
    """Item 16b-2 on the main path: ``main_bert --model bert_base
    --expert-shards 2 --expert-data-shards 2 --num-experts 4 --batch-size
    8 --compressor oktopk --density 0.01`` through its ``build_moe``:
    three steps on a 2 x 2 data x expert grid stacked on the card, the
    counters set to 0 just before and read just after (K1 and the
    compaction launched, threefry not), host ms a step, peak memory, the
    copies checked after every step, the first step's routing; the
    single-module oracle (rtol 1e-5); one ``--compute-dtype bfloat16``
    step; ``bert_tiny`` card against CPU. Its own budget,
    ``EXPERT_BUDGET_S``. Returns the BERT-base run's launches."""
    import torch
    t_phase = time.perf_counter()
    main = moe_run(dev, MOE_ARGV, MOE_STEPS)
    step = main.pop("run").step
    if ((step.moe_layout.n, step.shared_layout.n) != (N_MOE_SHARD,
                                                      N_MOE_SHARED)
            or (step.grid.dp, step.grid.ep, step.e_local) != (2, 2, 2)):
        raise AssertionError(f"moe buckets {step.moe_layout.n}, "
                             f"{step.shared_layout.n}, grid {step.grid.dp} "
                             f"x {step.grid.ep}")
    del step
    torch.cuda.empty_cache()
    assert_launched(main["launches"], SPARSE_KERNELS, "expert_parallel")
    if main["launches"]["threefry"]:
        raise AssertionError("moe: the deterministic forward launched "
                             "threefry")
    oracle = moe_oracle(dev, main.pop("batch"))
    bf16 = moe_run(dev, MOE_ARGV + ["--compute-dtype", "bfloat16"], 1)
    if bf16.pop("run").cfg.dtype != torch.bfloat16:
        raise AssertionError("moe --compute-dtype bfloat16 did not reach "
                             "the config")
    torch.cuda.empty_cache()
    tiny = {w: moe_run(w, MOE_TINY_ARGV, 2) for w in (str(dev), "cpu")}
    tiny_cmp = tiny_card_vs_cpu(
        dev, {w: t["recs"] for w, t in tiny.items()},
        {w: moe_thresholds(t["run"]) for w, t in tiny.items()}, "moe")
    del tiny
    ms = [r["ms"] for r in main["recs"]]
    secs = time.perf_counter() - t_phase
    emit({"phase": "expert_parallel", "model": "bert_base",
          "grid": "dp 2 x ep 2 stacked", "experts": 4,
          "experts_per_worker": 2, "batch_per_worker": 8, "seq": 128,
          "capacity_factor": 1.25, "capacity": 320, "density": 0.01,
          "buckets": {"expert_shard": N_MOE_SHARD, "shared": N_MOE_SHARED},
          "build_s": main["build_s"],
          "losses": [r["loss"] for r in main["recs"]],
          "comm_volume": [r["comm_volume"] for r in main["recs"]],
          "step_ms": ms, "exact_step_ms": ms[0],
          "steady_step_ms": spread(ms[1:]),
          "max_memory_allocated_gb": main["peak_gb"],
          "launches": main["launches"],
          "launches_per_step": {k: v / MOE_STEPS
                                for k, v in main["launches"].items()},
          "routing_step1": main["routing"],
          "shared_bit_identical": True, "experts_bit_identical": True,
          "oracle": oracle,
          "bf16": {"loss": bf16["recs"][0]["loss"],
                   "step_ms": bf16["recs"][0]["ms"],
                   "launches": bf16["launches"]},
          "tiny_card_vs_cpu": tiny_cmp, "seconds": secs})
    if secs > EXPERT_BUDGET_S:
        raise AssertionError(f"expert_parallel took {secs:.1f} s of its "
                             f"{EXPERT_BUDGET_S:.0f} s budget")
    return main["launches"]


# ---- the LSTM slice: DeepSpeech on AN4 (CTC) and the PTB LSTM ------------

def lstman4_tiny_weights(seed: int):
    """An ``lstman4_tiny`` state_dict drawn on the CPU."""
    import torch
    from oktopk_tpu_torch.models import create_model
    m = create_model("lstman4_tiny")
    m.init_weights(torch.Generator().manual_seed(seed))
    return m.state_dict()


def ctc_fwd_bwd(model, b, where):
    """Logits, CTC loss and the flat gradient in JAX leaf order of
    ``model`` (train mode) on the numpy batch ``b``, on ``where``."""
    import torch
    from oktopk_tpu_torch.models.layout import to_jax_layout
    from oktopk_tpu_torch.train.losses import ctc_loss
    from oktopk_tpu_torch.train.trainer import ctc_frame_len
    t = {k: torch.from_numpy(v).to(where) for k, v in b.items()}
    model.zero_grad(set_to_none=True)
    logits = model(t["spect"], train=True, update_stats=False)
    frames = torch.clamp(ctc_frame_len(t["spect_lengths"]),
                         max=logits.shape[1])
    loss = ctc_loss(logits, frames, t["labels"], t["label_lengths"])
    loss.backward()
    grad = torch.cat([to_jax_layout(p.grad, lay).reshape(-1)
                      for _, p, lay in model.jax_leaves()])
    return logits.detach(), loss.detach(), grad


def repeats(fn) -> bool:
    """Whether two calls of ``fn`` give bit-equal tensors."""
    import torch
    a, b = fn(), fn()
    return all(torch.equal(x.float().view(torch.int32),
                           y.float().view(torch.int32))
               for x, y in zip(a, b))


def phase_lstman4_parity(dev):
    """``lstman4_tiny`` (2 x 128) from the same seed's weights on the card
    (cuDNN's RNN, CUDA CTC) and on the CPU, train mode, 201 spectrogram
    frames (T' = 101), batch 4: logits within 1e-4 of the largest, loss
    within rtol 1e-4, the flat gradient in JAX leaf order within 1e-4 of
    its largest element (cuDNN's and the CPU's LSTM and CTC add in other
    orders); TF32 off. Then whether each piece repeats bit for bit on the
    card (two calls on the same inputs): the whole fwd/bwd, CTC's
    backward alone, and the cuDNN LSTM layer's backward alone."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from oktopk_tpu_torch.data import synthetic_batch
    from oktopk_tpu_torch.models import create_model
    from oktopk_tpu_torch.models.rnn import lstm

    sd = lstman4_tiny_weights(SEED)
    b = synthetic_batch("lstman4_tiny", 4, np.random.RandomState(SEED))
    out, models = {}, {}
    for where in ("cpu", dev):
        m = create_model("lstman4_tiny")
        m.load_state_dict(sd)
        models[str(where)] = m = m.to(where)
        out[str(where)] = [x.cpu() for x in ctc_fwd_bwd(m, b, where)]
    (c_lg, c_loss, c_grad), (g_lg, g_loss, g_grad) = (out["cpu"],
                                                      out[str(dev)])
    errs, tol = {}, 1e-4
    for nm, a, w in (("logits", g_lg, c_lg), ("flat_grad", g_grad, c_grad)):
        scale = float(w.abs().max())
        errs[nm] = float((a - w).abs().max())
        errs[nm + "_rel_largest"] = errs[nm] / scale
        if errs[nm] > tol * scale:
            raise AssertionError(f"lstman4_parity {nm}: max abs err "
                                 f"{errs[nm]} (largest {scale})")
    errs["loss"] = abs(float(g_loss) - float(c_loss))
    if not math.isfinite(float(g_loss)) or \
            errs["loss"] > tol * abs(float(c_loss)):
        raise AssertionError(f"lstman4_parity loss: {float(g_loss)} vs "
                             f"{float(c_loss)}")

    m = models[str(dev)]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lg = torch.randn((2, 101, 29), generator=gen, device=dev)
    frames = torch.tensor([101, 80], device=dev)
    labels = torch.randint(1, 29, (2, 40), generator=gen, device=dev)
    lab_len = torch.tensor([20, 12], device=dev)

    def ctc_grad():
        x = lg.clone().requires_grad_()
        F.ctc_loss(F.log_softmax(x, -1).transpose(0, 1), labels, frames,
                   lab_len, reduction="none").mean().backward()
        return [x.grad]

    x_rnn = torch.randn((2, 101, 128), generator=gen, device=dev)
    cells = (m.BatchRNN_1.OptimizedLSTMCell_0,
             m.BatchRNN_1.OptimizedLSTMCell_1)

    def rnn_grad():
        m.zero_grad(set_to_none=True)
        x = x_rnn.clone().requires_grad_()
        (lstm(x, cells) * x_rnn[..., :128]).sum().backward()
        return [x.grad] + [p.grad for c in cells for p in c.parameters()]

    verdict = {"fwd_bwd": repeats(lambda: ctc_fwd_bwd(m, b, dev)),
               "ctc_backward": repeats(ctc_grad),
               "cudnn_lstm_backward": repeats(rnn_grad)}
    emit({"phase": "lstman4_parity", "model": "lstman4_tiny",
          "n": sum(p.numel() for p in m.parameters()), "frames": 201,
          "batch": 4, "loss_card": float(g_loss), "loss_cpu": float(c_loss),
          "max_abs_err": errs, "tolerance_rel_largest": tol,
          "cudnn_deterministic": torch.backends.cudnn.deterministic,
          "cublas_workspace_config": os.environ.get(
              "CUBLAS_WORKSPACE_CONFIG"),
          "repeats_bit_equal_on_card": verdict})
    return errs, verdict


def trainer_run(dev, argv, steps: int, phase: str, profile: bool = False,
                build=None, after=None):
    """``steps`` steps of ``main_trainer.build_trainer(argv)`` (or of
    ``build()``'s (trainer, batches)) on the card (P = 4 workers
    stacked), CUDA events around the collective, launch counters set to
    0 just before the steps and read after each: per-step records, the
    launches, the peak memory, the trainer's digests and the model's
    compute dtype; with ``profile``, one more step under the profiler:
    its device launches, device time and the costliest kernels; then
    ``after(trainer, batches)``'s result."""
    import hashlib

    import torch
    from oktopk_tpu_torch.train import main_trainer

    t0 = time.perf_counter()
    if build is None:
        args = main_trainer.parse_args(
            argv + ["--device", str(dev), "--seed", str(SEED),
                    "--num-workers", "4", "--max-iters", str(steps)])
        trainer, data, _, _ = main_trainer.build_trainer(args)
    else:
        trainer, data = build()
    build_s = time.perf_counter() - t0
    batches = [next(data) for _ in range(steps)]
    clock = StepClock(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    recs, seen = [], read_counts()
    for s, b in enumerate(batches):
        clock.mark("start")
        t0 = time.perf_counter()
        m = trainer.train_step(b)
        clock.mark("end")
        torch.cuda.synchronize()
        now = read_counts()
        rec = {k: float(v) for k, v in m.items()}
        rec.update(step=s + 1, ms=(time.perf_counter() - t0) * 1e3,
                   collective=("dense" if s < trainer.algo_cfg.warmup_steps
                               else trainer.cfg.compressor),
                   **{f"{k}_calls": now[k] - seen[k] for k in now},
                   **clock.split())
        seen = now
        recs.append(rec)
        emit({"phase": phase, **rec})
    launches = read_counts()
    for r in recs:
        if not math.isfinite(r["loss"]):
            raise AssertionError(f"{phase} step {r['step']}: loss "
                                 f"{r['loss']}")
    digest = hashlib.sha1()
    for p in trainer.params:
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"{phase}: non-finite parameter")
        digest.update(p.detach().cpu().numpy().tobytes())
    profiled = None
    if profile:
        nxt = next(data)
        counts, by_op = profile_window(lambda: trainer.train_step(nxt), 1)
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
        profiled = {"device_launches": sum(counts.values()),
                    "device_ms": sum(by_op.values()),
                    "top_ms": {k: v for k, v in top},
                    "by_kind_ms": device_split(by_op)}
    out = {"n": trainer.algo_cfg.n, "k": trainer.algo_cfg.k,
           "profiled": profiled,
           "build_s": build_s, "recs": recs, "launches": launches,
           "max_memory_allocated_gb":
               torch.cuda.max_memory_allocated(dev) / 1e9,
           "params_sha1": digest.hexdigest(),
           "dtype": str(trainer.model.compute_dtype),
           "after": after(trainer, data) if after else None}
    del trainer, clock
    torch.cuda.empty_cache()
    return out


def split_summary(recs):
    """Medians and spreads of a run's steps (host ms, and the CUDA-event
    split into fwd/bwd with the flat copy, collective and optimizer)."""
    out = {}
    for k in ("ms", "fwd_bwd_ms", "collective_ms", "optimizer_ms"):
        v = [r[k] for r in recs]
        out[k] = {"median": statistics.median(v), "min": min(v),
                  "max": max(v)}
    return out


LSTMAN4_ARGV = ["--dnn", "lstman4", "--dataset", "an4", "--batch-size",
                "2", "--lr", "0.001", "--density", "0.02", "--grad-clip",
                "400", "--wire-dtype", "bfloat16", "--warmup-steps", "1"]


def phase_lstman4_trainer(dev, steps: int = 5):
    """The slice at full width through ``main_trainer.build_trainer``:
    DeepSpeech 5 x 800 (n = 54,791,168), P = 4 workers stacked on the
    card, bs 2 each (``LSTM/exp_configs/lstman4.conf``), 201 spectrogram
    frames (T' = 101), d = 0.02, ``--grad-clip 400``, bf16 wire: one
    dense warmup step, then four oktopk steps (the first the exact
    recomputes). Run twice from the same seed: whether the losses,
    volumes and final parameters repeat bit for bit. Returns the first
    run's launches."""
    runs = [trainer_run(dev, LSTMAN4_ARGV, steps, "lstman4_trainer")
            for _ in range(2)]
    first = runs[0]
    if first["n"] != N_LSTMAN4:
        raise AssertionError(f"lstman4 has {first['n']} parameters")
    sparse = first["recs"][1:]
    for r in sparse:
        if r["comm_volume"] <= 0:
            raise AssertionError(f"lstman4_trainer step {r['step']}: "
                                 "volume 0")
    assert_launched(first["launches"], SPARSE_KERNELS, "lstman4_trainer")
    keys = ("loss", "comm_volume", "wire_bytes", "local_k", "global_k")
    differ = [{"step": a["step"], **{k: [a[k], b[k]] for k in keys
                                     if a[k] != b[k]}}
              for a, b in zip(first["recs"], runs[1]["recs"])
              if any(a[k] != b[k] for k in keys)]
    emit({"phase": "lstman4_trainer_summary", "model": "lstman4",
          "n": first["n"], "k": first["k"], "workers": 4,
          "batch_per_worker": 2, "frames": 201, "density": 0.02,
          "grad_clip": 400, "steps": steps, "build_s": first["build_s"],
          "losses": [r["loss"] for r in first["recs"]],
          "volume": [r["comm_volume"] for r in first["recs"]],
          "local_k": [r["local_k"] for r in first["recs"]],
          "global_k": [r["global_k"] for r in first["recs"]],
          "wire_bytes": [r["wire_bytes"] for r in first["recs"]],
          "step_ms": [r["ms"] for r in first["recs"]],
          "oktopk_steps": split_summary(sparse),
          "predicted_steps": split_summary(sparse[1:]),
          "dense_step": {k: first["recs"][0][k] for k in (
              "ms", "fwd_bwd_ms", "collective_ms", "optimizer_ms")},
          "calls_per_oktopk_step": [
              {"fused_select": r["fused_select_calls"],
               "compaction": r["compaction_calls"]} for r in sparse],
          "launches": first["launches"],
          "max_memory_allocated_gb": first["max_memory_allocated_gb"],
          "second_run_step_ms": [r["ms"] for r in runs[1]["recs"]],
          "repeats_bit_equal": {
              "losses_and_volumes": not differ,
              "params": first["params_sha1"] == runs[1]["params_sha1"]},
          "differ": differ})
    return first["launches"]


def phase_lstm_trainer(dev, steps: int = 3):
    """The PTB LSTM at full width (2 x 1500, vocabulary 10,000, 35
    tokens, n = 66,022,000) through ``main_trainer.build_trainer``: P = 4
    workers stacked, bs 20 each (``VGG/exp_configs/lstm.conf``), lr 1.0,
    dropout 0.65 (JAX's masks from the threefry kernel; its three sites'
    masks card against CPU, bit-equal), oktopk at d = 0.02 with
    no dense warmup (step 1 the exact recomputes): three steps, losses
    finite, volumes reported. Returns the launches."""
    run = trainer_run(dev, ["--dnn", "lstm", "--dataset", "ptb",
                            "--batch-size", "20", "--lr", "1.0",
                            "--density", "0.02", "--warmup-steps", "0"],
                      steps, "lstm_trainer")
    assert_launched(run["launches"], DROPOUT_KERNELS, "lstm_trainer")
    from oktopk_tpu_torch.models.layers import site_hashes
    from oktopk_tpu_torch.models.lstm import dropout_sites
    from oktopk_tpu_torch.ops import prng
    sites = site_masks_equal(site_hashes(dropout_sites()),
                             prng.fold_in(prng.prng_key(SEED), 12),
                             [(20, 35, 1500)] * 3, 0.35, dev)
    emit({"phase": "lstm_trainer_summary", "model": "lstm", "n": run["n"],
          "k": run["k"], "workers": 4, "batch_per_worker": 20, "seq": 35,
          "dropout": 0.65, "site_masks_bit_equal": sites,
          "threefry_calls_per_step": [r["threefry_calls"]
                                      for r in run["recs"]],
          "steps": steps, "build_s": run["build_s"],
          "losses": [r["loss"] for r in run["recs"]],
          "volume": [r["comm_volume"] for r in run["recs"]],
          "local_k": [r["local_k"] for r in run["recs"]],
          "global_k": [r["global_k"] for r in run["recs"]],
          "step_ms": [r["ms"] for r in run["recs"]],
          "split": split_summary(run["recs"]),
          "launches": run["launches"],
          "max_memory_allocated_gb": run["max_memory_allocated_gb"]})
    return run["launches"]


# ---- one worker per process: phases 12 and 13 ----------------------------

DIST_P = 4
DIST_N = 1 << 20
DIST_DEADLINE_S = 420        # a rank that dies or hangs fails the phase
DIST_COLLECTIVE_TIMEOUT_S = 180


def dist_cases():
    """(name, registry name, config, per-step overrides) of the
    ``dist_allreduce`` phase, all on the bf16 wire: oktopk fused and
    unfused (cadences 2/2/3: step 0 recomputes and repartitions, step 1
    predicts, step 2 recomputes), each baseline (cadence 2, exact top-k
    thresholds), and topkSA whose first step takes the dense fallback
    (density 1) and whose second does not."""
    ok = dict(n=DIST_N, num_workers=DIST_P, density=0.02, warmup_steps=0,
              local_recompute_every=2, global_recompute_every=2,
              repartition_every=3, threshold_method="hist")
    base = dict(n=DIST_N, num_workers=DIST_P, density=0.02, warmup_steps=0,
                local_recompute_every=2, threshold_method="sort")
    three = [{}, {}, {}]
    return ([("oktopk", "oktopk", ok, three),
             ("oktopk unfused", "oktopk", dict(ok, fuse_select=False),
              three)]
            + [(nm, nm, base, three) for nm in BASELINES]
            + [("topkSA dense fallback", "topkSA",
                dict(base, local_recompute_every=1), [{"density": 1.0},
                                                      {}])])


def dist_grads(steps: int, P: int, n: int):
    import numpy as np
    rng = np.random.RandomState(SEED)
    base = rng.randn(P, n).astype(np.float32)
    return [base + 0.3 * rng.randn(P, n).astype(np.float32)
            for _ in range(steps)]


def row_digests(arrays, row: int) -> dict:
    """sha1 of the bytes of row ``row`` of each array."""
    import hashlib
    import numpy as np
    return {k: hashlib.sha1(np.ascontiguousarray(v[row]).tobytes())
            .hexdigest() for k, v in arrays.items()}


def run_dist_case(case, comm, dev, P: int = DIST_P):
    """The case's steps over ``comm`` from the fresh state, on this
    process's gradient rows: per step, the host arrays of the result and
    of every state field ([W, ...]) and the step's host ms."""
    import torch
    from oktopk_tpu_torch.collectives.api import build_allreduce_step
    from oktopk_tpu_torch.collectives.state import init_state
    from oktopk_tpu_torch.config import OkTopkConfig

    _, algo, kw, steps = case
    rows = slice(comm.first_worker, comm.first_worker + comm.local_workers)
    grads = dist_grads(len(steps), P, kw["n"])
    state = init_state(OkTopkConfig(**kw), comm.local_workers, dev)
    out = []
    for i, over in enumerate(steps):
        step = build_allreduce_step(algo, OkTopkConfig(**dict(kw, **over)),
                                    comm, warmup=False)
        g = torch.from_numpy(grads[i][rows]).to(dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res, state = step(g, state)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        out.append(({"result": res.cpu().numpy(), **state.to_numpy()}, ms))
    return out


def dist_join(rank: int, world: int, tmp: str, backend: str, dev: str):
    """Join a group of ``world`` over a file store in ``tmp`` (no port to
    race for) through the launch layer; returns its comm."""
    import datetime

    import torch
    import torch.distributed as dist
    from oktopk_tpu_torch import launch
    from oktopk_tpu_torch.comm import ProcessGroupComm
    # the variables torchrun would set; the rendezvous is the file store
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    store = f"file://{tmp}/store"
    if world > 1:
        launch.maybe_initialize(backend, dev, init_method=store,
                                timeout_s=DIST_COLLECTIVE_TIMEOUT_S)
    else:           # the launch layer leaves one process alone
        torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=store, rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=DIST_COLLECTIVE_TIMEOUT_S))
    return ProcessGroupComm()


def dist_guard(job, rank: int, tmp: str, *args):
    """Run ``job`` as a rank: its JSON result to ``rank{r}.json``, or its
    traceback to ``rank{r}.err`` and exit code 1."""
    import traceback
    try:
        res = job(rank, tmp, *args)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def _allreduce_rank(rank: int, tmp: str, world: int, dev: str):
    comm = dist_join(rank, world, tmp, "gloo", dev)
    out = {"backend": comm.backend, "cases": {}}
    for case in dist_cases():
        zero_counts()
        steps = run_dist_case(case, comm, dev)
        out["cases"][case[0]] = {
            "digests": [row_digests(a, 0) for a, _ in steps],
            "ms": [ms for _, ms in steps],
            "launches": read_counts()}
    return out


def allreduce_rank(rank, tmp, world, dev):
    """Spawn target: every ``dist_cases`` case as one gloo rank."""
    dist_guard(_allreduce_rank, rank, tmp, world, dev)


def _nccl_rank(rank: int, tmp: str, dev: str):
    """World size 1 over NCCL: the comm's verbs with the path's dtypes and
    three oktopk steps, each against ``StackedComm(1)``."""
    import torch
    from oktopk_tpu_torch.comm import StackedComm
    comm = dist_join(rank, 1, tmp, "nccl", dev)
    stacked = StackedComm(1)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((1, 1, 4096), generator=gen, device=dev)
    idx = torch.randint(0, 1 << 20, (1, 1, 4096), generator=gen,
                        device=dev, dtype=torch.int32)
    verbs = {}
    for nm, fn, t in (
            ("psum f32", "psum", x[0]), ("psum i32", "psum", idx[0]),
            ("psum i64", "psum", idx[0].long()),
            ("all_gather bf16", "all_gather", x[0].bfloat16()),
            ("all_gather i32", "all_gather", idx[0]),
            ("all_to_all bf16", "all_to_all", x.bfloat16()),
            ("all_to_all i32", "all_to_all", idx),
            ("all_to_all i64", "all_to_all", idx.long())):
        bits_equal(getattr(comm, fn)(t).float(),
                   getattr(stacked, fn)(t).float(), f"nccl {nm}")
        verbs[nm] = True
    name, algo, kw, steps = dist_cases()[0]
    case = (name, algo, dict(kw, num_workers=1), steps)
    got = run_dist_case(case, comm, dev, P=1)
    want = run_dist_case(case, stacked, dev, P=1)
    for i, ((a, ms), (b, _)) in enumerate(zip(got, want)):
        if row_digests(a, 0) != row_digests(b, 0):
            raise AssertionError(f"nccl oktopk step {i} differs from "
                                 "StackedComm(1)")
    return {"backend": comm.backend, "verbs_bit_equal": verbs,
            "oktopk_steps_bit_equal": len(got),
            "oktopk_ms": [ms for _, ms in got]}


def nccl_rank(rank, tmp, dev):
    """Spawn target: the NCCL check at world size 1."""
    dist_guard(_nccl_rank, rank, tmp, dev)


def spawn_ranks(target, world: int, args, what: str):
    """Run ``target(rank, tmp, *args)`` in ``world`` spawned processes and
    join them by ``DIST_DEADLINE_S``; raise with the ranks' tracebacks if
    any failed or hung (those still running are killed). Returns the
    ranks' JSON results."""
    import multiprocessing as mp
    import tempfile
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="oktopk_dist_") as tmp:
        procs = [ctx.Process(target=target, args=(r, tmp) + tuple(args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + DIST_DEADLINE_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errs = {r: open(os.path.join(tmp, f"rank{r}.err")).read()
                for r in range(world)
                if os.path.exists(os.path.join(tmp, f"rank{r}.err"))}
        codes = [p.exitcode for p in procs]
        if hung or errs or any(c != 0 for c in codes):
            raise AssertionError(f"{what}: exit codes {codes}, hung ranks "
                                 f"{hung}, errors {errs}")
        return [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                for r in range(world)]


def phase_dist_allreduce(dev):
    """(a) Every ``dist_cases`` case on ``StackedComm(4)`` on the card in
    this process, then in four gloo processes on the same card (NCCL
    refuses two ranks on one device), each a ``ProcessGroupComm`` rank,
    from the same seeded state: every rank's result, residual,
    thresholds, boundaries, counts and volumes bit-equal (sha1 of their
    bytes) to the stacked comm's row. (b) One NCCL process at world size
    1 against ``StackedComm(1)``."""
    from oktopk_tpu_torch.comm import StackedComm

    t0 = time.perf_counter()
    want = {}
    for case in dist_cases():
        steps = run_dist_case(case, StackedComm(DIST_P), dev)
        want[case[0]] = [[row_digests(a, r) for r in range(DIST_P)]
                         for a, _ in steps]
    ranks = spawn_ranks(allreduce_rank, DIST_P, (DIST_P, str(dev)),
                        "dist_allreduce gloo")
    for name, per_step in want.items():
        for r, res in enumerate(ranks):
            got = res["cases"][name]["digests"]
            for i, (g, w) in enumerate(zip(got, per_step)):
                bad = sorted(k for k in w[r] if g[k] != w[r][k])
                if bad:
                    raise AssertionError(f"dist_allreduce {name} step {i} "
                                         f"rank {r}: {bad} differ")
    nccl = spawn_ranks(nccl_rank, 1, (str(dev),), "dist_allreduce nccl")[0]
    emit({"phase": "dist_allreduce", "n": DIST_N, "P": DIST_P,
          "backend": ranks[0]["backend"], "placement": f"4 ranks on {dev}",
          "bit_equal_to_stacked": True,
          "fields": sorted(next(iter(want.values()))[0][0]),
          "cases": {nm: {"steps": len(per_step),
                         "per_rank_step_ms": [res["cases"][nm]["ms"]
                                              for res in ranks],
                         "per_rank_launches": [res["cases"][nm]["launches"]
                                               for res in ranks]}
                    for nm, per_step in want.items()},
          "nccl_world_1": nccl, "wall_s": time.perf_counter() - t0})


def run_hier_case(outer: str, comm, dev):
    """Three two-level steps (``hier_config(outer, DIST_N)``) over the
    two-level ``comm`` from the fresh state, on this process's gradient
    rows: per step, the host arrays of the result and of every state
    field and the step's host ms."""
    import torch
    from oktopk_tpu_torch.collectives.api import (batched_init_state,
                                                  build_allreduce_step)

    h = hier_config(outer, DIST_N)
    step = build_allreduce_step("hierarchical", h, comm, warmup=False)
    rows = slice(comm.first_worker, comm.first_worker + comm.local_workers)
    state = batched_init_state(h, dev, comm=comm)
    out = []
    for g in dist_grads(3, h.num_workers, DIST_N):
        g = torch.from_numpy(g[rows]).to(dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res, state = step(g, state)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        out.append(({"result": res.cpu().numpy(), **state.to_numpy()}, ms))
    return out


def _hier_rank(rank: int, tmp: str, world: int, dev: str):
    from oktopk_tpu_torch.comm import hierarchical_process_comm
    dist_join(rank, world, tmp, "gloo", dev)
    comm = hierarchical_process_comm(HIER_PODS, HIER_POD_SIZE)
    out = {"backend": comm.backend,
           "intra_rank": comm.intra.first_worker,
           "inter_rank": comm.inter.first_worker, "cases": {}}
    for outer in HIER_OUTERS:
        zero_counts()
        steps = run_hier_case(outer, comm, dev)
        out["cases"][outer] = {
            "digests": [row_digests(a, 0) for a, _ in steps],
            "ms": [ms for _, ms in steps],
            "launches": read_counts()}
    return out


def hier_rank(rank, tmp, world, dev):
    """Spawn target: the two-level cases as one gloo rank of 2 pods x
    2."""
    dist_guard(_hier_rank, rank, tmp, world, dev)


def phase_dist_hierarchical(dev):
    """The two-level step as four gloo processes on the card, 2 pods x 2
    over ``dist.new_group`` groups (each rank its pod's intra group and
    its member index's inter group), with the dense, oktopk and topkA
    outers, three steps each at n = 2^20: every rank's result and state
    bit-equal (sha1 of their bytes) to the two-level stacked comm's row
    on the card. Returns rank 0's launches on the oktopk outer."""
    from oktopk_tpu_torch.comm import hierarchical_comm

    t0 = time.perf_counter()
    want = {o: [[row_digests(a, r) for r in range(DIST_P)]
                for a, _ in run_hier_case(
                    o, hierarchical_comm(HIER_PODS, HIER_POD_SIZE), dev)]
            for o in HIER_OUTERS}
    ranks = spawn_ranks(hier_rank, DIST_P, (DIST_P, str(dev)),
                        "dist_hierarchical gloo")
    for r, res in enumerate(ranks):
        if (res["intra_rank"], res["inter_rank"]) != (
                r % HIER_POD_SIZE, r // HIER_POD_SIZE):
            raise AssertionError(f"dist_hierarchical rank {r}: group ranks "
                                 f"{res['intra_rank']}, {res['inter_rank']}")
        for outer, per_step in want.items():
            for i, (g, w) in enumerate(zip(res["cases"][outer]["digests"],
                                           per_step)):
                bad = sorted(k for k in w[r] if g[k] != w[r][k])
                if bad:
                    raise AssertionError(f"dist_hierarchical {outer} step "
                                         f"{i} rank {r}: {bad} differ")
    emit({"phase": "dist_hierarchical", "n": DIST_N, "pods": HIER_PODS,
          "pod_size": HIER_POD_SIZE, "backend": ranks[0]["backend"],
          "placement": f"4 ranks on {dev}", "bit_equal_to_stacked": True,
          "cases": {o: {"steps": len(want[o]),
                        "per_rank_step_ms": [res["cases"][o]["ms"]
                                             for res in ranks],
                        "per_rank_launches": [res["cases"][o]["launches"]
                                              for res in ranks]}
                    for o in HIER_OUTERS},
          "wall_s": time.perf_counter() - t0})
    return ranks[0]["cases"]["oktopk"]["launches"]


def vgg_args(extra):
    from oktopk_tpu_torch.train import main_trainer
    return main_trainer.parse_args(
        ["--dnn", "vgg16", "--batch-size", "16", "--seed", str(SEED),
         "--warmup-steps", "1", "--max-iters", "4"] + extra)


def run_vgg_steps(trainer, data, steps: int):
    """``steps`` trainer steps, launch counters set to 0 just before and
    read just after: per-step metrics and host ms, and the launches."""
    import torch
    batches = [next(data) for _ in range(steps)]
    torch.cuda.synchronize()
    zero_counts()
    recs = []
    for b in batches:
        t0 = time.perf_counter()
        m = trainer.train_step(b)
        torch.cuda.synchronize()
        recs.append({**{k: float(v) for k, v in m.items()},
                     "ms": (time.perf_counter() - t0) * 1e3})
    return recs, read_counts()


def _trainer_rank(rank: int, tmp: str, world: int, dev: str,
                  want_path: str):
    import torch
    from oktopk_tpu_torch.train import main_trainer
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dist_join(rank, world, tmp, "gloo", dev)
    trainer, data, penv, _ = main_trainer.build_trainer(
        vgg_args(["--device", dev, "--backend", "gloo"]))
    if not trainer.distributed or penv.num_processes != world:
        raise AssertionError("build_trainer did not take the "
                             "multi-process path")
    recs, launches = run_vgg_steps(trainer, data, 4)
    got = trainer.model.state_dict()
    want = {k: v.to(dev) for k, v in torch.load(want_path).items()}
    return {"steps": recs, "launches": launches,
            "comm": type(trainer.comm).__name__,
            "backend": trainer.comm.backend, "source": penv.source,
            "state_bit_equal": all(torch.equal(got[k], want[k])
                                   for k in want),
            "state_max_abs_diff": {
                k: float((got[k].double() - want[k].double()).abs().max())
                for k in want}}


def trainer_rank(rank, tmp, world, dev, want_path):
    """Spawn target: full-width VGG-16 as one gloo rank of ``world``,
    built by ``main_trainer.build_trainer``; its final state compared
    with the stacked trainer's, saved by the parent at ``want_path``."""
    dist_guard(_trainer_rank, rank, tmp, world, dev, want_path)


def _autotune_rank(rank: int, tmp: str, world: int, dev: str):
    from oktopk_tpu_torch.train import main_trainer
    dist_join(rank, world, tmp, "gloo", dev)
    trainer, data, penv, _ = main_trainer.build_trainer(vgg_args(
        ["--device", dev, "--backend", "gloo", "--num-buckets", "2",
         "--autotune", "--autotune-candidates", "dense,oktopk",
         "--autotune-trial-steps", "3"]))
    if not trainer.distributed or penv.num_processes != world:
        raise AssertionError("build_trainer did not take the "
                             "multi-process path")
    t0 = time.perf_counter()
    plans = trainer.autotune(step=0)
    secs = time.perf_counter() - t0
    m = trainer.train_step(next(data))
    dec = [e for e in trainer.autotuner.journal.entries
           if e["event"] == "decision"]
    return {"coeffs": trainer.autotuner.coeffs.as_dict(),
            "plan": [[p.algo, p.density, p.measured_ms] for p in plans],
            "candidates_ms": [{c["algo"]: c["measured_ms"]
                               for c in d["candidates"]} for d in dec],
            "names": list(trainer.grad_step.names),
            "loss": float(m["loss"]), "tune_seconds": secs}


def autotune_rank(rank, tmp, world, dev):
    """Spawn target: full-width VGG-16 as one gloo rank of ``world``,
    built by ``main_trainer.build_trainer --autotune`` over two buckets:
    one real calibrate -> trial -> policy pass and one planned step."""
    dist_guard(_autotune_rank, rank, tmp, world, dev)


def run_cli(cmd, timeout_s: float, env=None):
    """Run ``cmd`` in its own session from the repository root; on
    timeout kill the whole session (the launcher and its workers) and
    raise."""
    import signal
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env,
                         cwd=ROOT, start_new_session=True)
    try:
        out, _ = p.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise AssertionError(f"{' '.join(cmd)} did not end in "
                             f"{timeout_s} s")
    return p.returncode, out


def phase_dist_trainer(dev):
    """Full-width VGG-16 (n = 14,728,266) through ``main_trainer.
    build_trainer``: four gloo ranks on the card against the stacked
    Trainer (4 workers) on the card from the same seed, one dense warmup
    step then three oktopk steps, global batch 64, cuDNN deterministic in
    both: per-step losses and ``comm_volume`` equal, parameters and
    BatchNorm buffers bit-equal on every rank. Then the ``torchrun`` CLI,
    four ranks of three steps, which must exit 0 with rank 0's log
    lines. Returns rank 0's launches on the path."""
    import tempfile

    import torch
    from oktopk_tpu_torch.train import main_trainer

    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        trainer, data, _, _ = main_trainer.build_trainer(vgg_args(
            ["--device", str(dev), "--num-workers", str(DIST_P)]))
        if trainer.algo_cfg.n != N_VGG16 or trainer.distributed:
            raise AssertionError("the stacked VGG-16 trainer was not built")
        want, want_launches = run_vgg_steps(trainer, data, 4)
        with tempfile.TemporaryDirectory(prefix="oktopk_want_") as wd:
            want_path = os.path.join(wd, "stacked.pt")
            torch.save({k: v.cpu() for k, v in
                        trainer.model.state_dict().items()}, want_path)
            del trainer
            torch.cuda.empty_cache()
            ranks = spawn_ranks(trainer_rank, DIST_P,
                                (DIST_P, str(dev), want_path),
                                "dist_trainer")
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev
    for r, res in enumerate(ranks):
        for s, (g, w) in enumerate(zip(res["steps"], want)):
            for k in ("loss", "comm_volume", "wire_bytes", "local_k",
                      "global_k"):
                if g[k] != w[k]:
                    raise AssertionError(f"dist_trainer rank {r} step {s}: "
                                         f"{k} {g[k]} vs stacked {w[k]}")
        if not res["state_bit_equal"]:
            raise AssertionError(
                f"dist_trainer rank {r}: parameters or buffers differ from "
                f"the stacked trainer: {res['state_max_abs_diff']}")
        assert_launched(res["launches"], SPARSE_KERNELS,
                        f"dist_trainer rank {r}")
    emit({"phase": "dist_trainer", "model": "vgg16", "n": N_VGG16,
          "ranks": DIST_P, "placement": f"4 gloo ranks on {dev}",
          "global_batch": 64, "steps": 4, "collective": ["dense"]
          + ["oktopk"] * 3, "bit_equal_to_stacked": True,
          "losses": [w["loss"] for w in want],
          "comm_volume": [w["comm_volume"] for w in want],
          "stacked_step_ms": [w["ms"] for w in want],
          "per_rank_step_ms": [[s["ms"] for s in res["steps"]]
                               for res in ranks],
          "dense_warmup_ms_per_rank": [res["steps"][0]["ms"]
                                       for res in ranks],
          "stacked_launches": want_launches,
          "per_rank_launches": [res["launches"] for res in ranks],
          "note": "four processes share one card and gloo stages through "
                  "the host: the step times are no multi-card number"})

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(DIST_P), "-m",
           "oktopk_tpu_torch.train.main_trainer", "--backend", "gloo",
           "--device", str(dev), "--dnn", "vgg16", "--max-iters", "3",
           "--warmup-steps", "1"]
    t0 = time.perf_counter()
    rc, out = run_cli(cmd, DIST_DEADLINE_S)
    cli_s = time.perf_counter() - t0
    lines = [ln for ln in out.splitlines()
             if "experiment" in ln or "done:" in ln]
    if rc != 0 or len(lines) != 2 or "4 processes (torchrun, gloo)" \
            not in lines[0]:
        raise AssertionError(f"torchrun CLI: exit {rc}, log lines {lines}"
                             f"\n{out[-4000:]}")
    # its third step is dist_trainer's third: cuDNN deterministic in the
    # Trainer (H15) makes the loss and the volume equal, not near
    done = re.search(r"loss (\S+), vol/step (\d+)", lines[1])
    cli = {"loss": float(done.group(1)), "comm_volume": int(done.group(2))}
    ref = {"loss": want[2]["loss"], "comm_volume": int(want[2]["comm_volume"])}
    if cli != ref:
        raise AssertionError(f"torchrun CLI: last step {cli}, dist_trainer "
                             f"{ref}")
    emit({"phase": "dist_trainer_cli", "cmd": " ".join(cmd[1:]),
          "exit": rc, "rank0_log": lines, "seconds": cli_s,
          "last_step": cli, "equal_to_dist_trainer": True})

    # the autotuner across processes: every rank fits the same
    # coefficients and takes the same plan (the medians agreed)
    t0 = time.perf_counter()
    tuned = spawn_ranks(autotune_rank, DIST_P, (DIST_P, str(dev)),
                        "dist_trainer autotune")
    want = {k: tuned[0][k] for k in ("coeffs", "plan", "candidates_ms",
                                     "names")}
    for r, res in enumerate(tuned):
        if {k: res[k] for k in want} != want or not math.isfinite(
                res["loss"]) or res["names"] != [p[0] for p in
                                                 res["plan"]]:
            raise AssertionError(f"dist_trainer autotune rank {r}: {res} "
                                 f"against rank 0's {want}")
    emit({"phase": "dist_trainer_autotune", "ranks": DIST_P,
          "placement": f"4 gloo ranks on {dev}", "num_buckets": 2,
          "same_on_every_rank": True, **want,
          "losses": [res["loss"] for res in tuned],
          "tune_seconds": [res["tune_seconds"] for res in tuned],
          "seconds": time.perf_counter() - t0,
          "note": "four processes share one card and gloo stages through "
                  "the host: the trial times are no multi-card number"})
    return ranks[0]["launches"]


BERT_DIST_ARGV = ["--model", "bert_tiny", "--num-minibatches", "3",
                  "--seed", str(SEED), "--density", "0.02"]


def run_bert_steps(trainer, data, steps: int = 3):
    """``steps`` BERT steps, counters set to 0 just before and read just
    after: per-step metrics, the launches, and sha1 digests of the final
    state_dict."""
    import hashlib

    import torch
    batches = [next(data) for _ in range(steps)]
    torch.cuda.synchronize()
    zero_counts()
    recs = []
    for b in batches:
        t0 = time.perf_counter()
        m = trainer.train_step(b)
        torch.cuda.synchronize()
        recs.append({**{k: float(v) for k, v in m.items()},
                     "ms": (time.perf_counter() - t0) * 1e3})
    digests = {k: hashlib.sha1(v.detach().cpu().numpy().tobytes())
               .hexdigest() for k, v in trainer.model.state_dict().items()}
    return recs, read_counts(), digests


def _bert_rank(rank: int, tmp: str, world: int, dev: str):
    from oktopk_tpu_torch.train import main_bert
    dist_join(rank, world, tmp, "gloo", dev)
    trainer, data = main_bert.build_trainer(main_bert.parse_args(
        BERT_DIST_ARGV + ["--device", dev, "--backend", "gloo"]))
    if not trainer.distributed:
        raise AssertionError("main_bert did not take the multi-process "
                             "path")
    recs, launches, digests = run_bert_steps(trainer, data)
    return {"steps": recs, "launches": launches, "digests": digests}


def bert_rank(rank, tmp, world, dev):
    """Spawn target: ``bert_tiny`` (dropout 0.1) as one gloo rank of
    ``world``, built by ``main_bert.build_trainer``."""
    dist_guard(_bert_rank, rank, tmp, world, dev)


def phase_dist_bert(dev):
    """BERT across processes: ``bert_tiny`` with dropout 0.1 through
    ``main_bert.build_trainer`` as four gloo ranks on the card, each
    drawing its own worker's dropout masks, against the stacked Trainer
    (4 workers) on the card from the same seed; oktopk at d = 0.02 with
    the BERT cadences, three steps: losses, volumes and counts equal and
    every ``state_dict`` entry bit-equal (sha1) on every rank. Returns
    rank 0's launches."""
    import torch
    from oktopk_tpu_torch.train import main_bert

    trainer, data = main_bert.build_trainer(main_bert.parse_args(
        BERT_DIST_ARGV + ["--device", str(dev), "--num-workers",
                          str(DIST_P)]))
    if trainer.distributed:
        raise AssertionError("the stacked bert_tiny trainer was not built")
    want, want_launches, want_digests = run_bert_steps(trainer, data)
    del trainer
    torch.cuda.empty_cache()
    ranks = spawn_ranks(bert_rank, DIST_P, (DIST_P, str(dev)), "dist_bert")
    keys = ("loss", "mlm_loss", "nsp_loss", "comm_volume", "wire_bytes",
            "local_k", "global_k")
    for r, res in enumerate(ranks):
        for s, (g, w) in enumerate(zip(res["steps"], want)):
            for k in keys:
                if g[k] != w[k]:
                    raise AssertionError(f"dist_bert rank {r} step {s}: {k} "
                                         f"{g[k]} vs stacked {w[k]}")
        bad = sorted(k for k in want_digests
                     if res["digests"][k] != want_digests[k])
        if bad:
            raise AssertionError(f"dist_bert rank {r}: {bad} differ from "
                                 "the stacked trainer")
        assert_launched(res["launches"], DROPOUT_KERNELS,
                        f"dist_bert rank {r}")
    emit({"phase": "dist_bert", "model": "bert_tiny", "dropout": 0.1,
          "ranks": DIST_P, "placement": f"4 gloo ranks on {dev}",
          "steps": 3, "bit_equal_to_stacked": True,
          "losses": [w["loss"] for w in want],
          "comm_volume": [w["comm_volume"] for w in want],
          "stacked_step_ms": [w["ms"] for w in want],
          "per_rank_step_ms": [[s["ms"] for s in res["steps"]]
                               for res in ranks],
          "stacked_launches": want_launches,
          "per_rank_launches": [res["launches"] for res in ranks]})
    return ranks[0]["launches"]


PIPE_DIST_ARGV = ["--model", "bert_tiny", "--pipeline-stages", "2",
                  "--num-microbatches", "2", "--batch-size", "2",
                  "--density", "0.02", "--num-minibatches", "3", "--seed",
                  str(SEED)]


def run_pipeline_steps(run, steps: int = 3):
    """``steps`` pipeline steps, counters set to 0 just before and read
    just after: per-step metrics and host ms, the launches, and sha1
    digests of each held stage's and the shared flat parameters and
    BertAdam moments and of every sparse state field, by data row."""
    import hashlib

    import torch
    batches = [next(run.data) for _ in range(steps)]
    keys = [run.next_key() for _ in range(steps)]
    torch.cuda.synchronize()
    zero_counts()
    recs = []
    for b, k in zip(batches, keys):
        t0 = time.perf_counter()
        m = run.step(b, k)
        torch.cuda.synchronize()
        recs.append({**{k: float(v) for k, v in m.items()},
                     "ms": (time.perf_counter() - t0) * 1e3})
    launches = read_counts()

    def sha(t):
        return hashlib.sha1(t.detach().cpu().numpy().tobytes()).hexdigest()

    step = run.step
    opt_stage, opt_shared = step.opt_states
    states, shared_state = step.sstates
    digests = {}
    for i, d in enumerate(run.grid.data_rows):
        for w, s in enumerate(run.grid.stages):
            b = step.stage_buckets[w]
            digests[f"row{d} stage{s}"] = {
                "params": sha(b.flat(b.params)), "m": sha(opt_stage[w].m),
                "v": sha(opt_stage[w].v),
                **{f: sha(t[i]) for f, t in states[w].__dict__.items()
                   if isinstance(t, torch.Tensor)}}
        sb = step.shared_bucket
        digests[f"row{d} shared"] = {
            "params": sha(sb.flat(sb.params)), "m": sha(opt_shared.m),
            "v": sha(opt_shared.v),
            **{f: sha(t[i]) for f, t in shared_state.__dict__.items()
               if isinstance(t, torch.Tensor)}}
    return recs, launches, digests


def _pipe_rank(rank: int, tmp: str, world: int, dev: str):
    from oktopk_tpu_torch.train import main_bert
    dist_join(rank, world, tmp, "gloo", dev)
    run = main_bert.build_pipeline(main_bert.parse_args(
        PIPE_DIST_ARGV + ["--device", dev, "--backend", "gloo"]))
    if not run.grid.distributed:
        raise AssertionError("main_bert did not take the multi-process "
                             "pipeline")
    recs, launches, digests = run_pipeline_steps(run)
    return {"steps": recs, "launches": launches, "digests": digests,
            "row": list(run.grid.data_rows), "stage": list(run.grid.stages)}


def pipe_rank(rank, tmp, world, dev):
    """Spawn target: the pipeline (bert_tiny, pp = 2) as one gloo rank of
    ``world``, built by ``main_bert.build_pipeline``."""
    dist_guard(_pipe_rank, rank, tmp, world, dev)


def phase_dist_pipeline(dev):
    """The pipeline across processes: ``bert_tiny`` with dropout 0.1
    through ``main_bert.build_pipeline`` as four gloo ranks on the card,
    pp = 2 x dp = 2 (rank d * 2 + s data row d, stage s, over
    ``dist.new_group`` groups), against the stacked grid on the card from
    the same seed; oktopk at d = 0.02, M = 2, three steps: losses and
    volumes equal and each rank's stage and shared parameters, BertAdam
    moments and sparse-state rows bit-equal (sha1) to the stacked grid's.
    Returns rank 0's launches."""
    import torch
    from oktopk_tpu_torch.train import main_bert

    run = main_bert.build_pipeline(main_bert.parse_args(
        PIPE_DIST_ARGV + ["--device", str(dev), "--num-workers",
                          str(DIST_P)]))
    if run.grid.distributed:
        raise AssertionError("the stacked pipeline was not built")
    want, want_launches, want_digests = run_pipeline_steps(run)
    del run
    torch.cuda.empty_cache()
    ranks = spawn_ranks(pipe_rank, DIST_P, (DIST_P, str(dev)),
                        "dist_pipeline")
    for r, res in enumerate(ranks):
        d, s = divmod(r, 2)
        if (res["row"], res["stage"]) != ([d], [s]):
            raise AssertionError(f"dist_pipeline rank {r}: row "
                                 f"{res['row']} stage {res['stage']}")
        for i, (g, w) in enumerate(zip(res["steps"], want)):
            for k in ("loss", "comm_volume"):
                if g[k] != w[k]:
                    raise AssertionError(f"dist_pipeline rank {r} step {i}:"
                                         f" {k} {g[k]} vs stacked {w[k]}")
        for part in (f"row{d} stage{s}", f"row{d} shared"):
            bad = sorted(k for k, v in want_digests[part].items()
                         if res["digests"][part][k] != v)
            if bad:
                raise AssertionError(f"dist_pipeline rank {r} {part}: "
                                     f"{bad} differ from the stacked grid")
        assert_launched(res["launches"], DROPOUT_KERNELS,
                        f"dist_pipeline rank {r}")
    emit({"phase": "dist_pipeline", "model": "bert_tiny", "dropout": 0.1,
          "ranks": DIST_P, "grid": "dp 2 x pp 2, one worker per process",
          "placement": f"4 gloo ranks on {dev}", "steps": 3,
          "bit_equal_to_stacked": True,
          "losses": [w["loss"] for w in want],
          "comm_volume": [w["comm_volume"] for w in want],
          "stacked_step_ms": [w["ms"] for w in want],
          "per_rank_step_ms": [[s["ms"] for s in res["steps"]]
                               for res in ranks],
          "stacked_launches": want_launches,
          "per_rank_launches": [res["launches"] for res in ranks]})
    return ranks[0]["launches"]


# ---- slice 8: JAX's dropout masks, the CNN zoo, the image loaders -------

N_RESNET50 = 25557032          # ResNet-50's flat parameter count
# the card's 32-bit integer rate: 132 SMs x 64 INT32 lanes x 1.98 GHz
# (half the float32 lanes behind the data sheet's 67 TFLOP/s)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Random123's threefry2x32_20 known answers: key, counter, output words
THREEFRY_KAT = [((0x00000000, 0x00000000), (0x00000000, 0x00000000),
                 (0x6b200159, 0x99ba4efe)),
                ((0xffffffff, 0xffffffff), (0xffffffff, 0xffffffff),
                 (0x1cb996fc, 0xbb002be7)),
                ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
                 (0xc4923a9c, 0x483df7a0))]
THREEFRY_LAUNCHES = {"keep_mask_kernel": 1}
# the masks the BERT-base path draws: attention probabilities (one mask
# broadcast over batch and heads) and a hidden state, bs 8, seq 128
THREEFRY_FORMS = {"threefry_attention": (1, 1, 128, 128),
                  "threefry_hidden": (8, 128, 768)}


def threefry_bound_ms(n: int) -> float:
    """The larger of the mask's bytes over the memory rate and its integer
    operations over the INT32 rate (the latter binds)."""
    from oktopk_tpu_torch.ops import prng
    return max(n / HBM_BYTES_PER_S,
               prng.INT_OPS_PER_ELEMENT * n / INT32_OPS_PER_S) * 1e3


def phase_threefry(dev):
    """``csrc/threefry.cu``: the known answers (the output words on the
    host; on the card the mask at each answer's counter, under a keep
    probability equal to the answer's float and to the next float above
    it, which pins the 23 bits the mask reads), the kernel bit-equal to
    its plain version at odd lengths and at counters past 2^32 (an
    offset, not a 4 GB mask) and one launch a mask; then timed at the
    BERT-base path's two mask shapes."""
    import numpy as np
    import torch
    from oktopk_tpu_torch.ops import prng

    for key, ctr, out in THREEFRY_KAT:
        got = prng._threefry_np(*(np.uint64(w) for w in key + ctr))
        if tuple(int(w) for w in got) != out:
            raise AssertionError(f"threefry {key} {ctr}: {got} != {out}")
        bits = np.uint32((out[0] ^ out[1]) >> 9 | 0x3F800000)
        u = bits.view(np.float32) - np.float32(1.0)
        above = np.nextafter(u, np.float32(2.0))
        off = (ctr[0] << 32) | ctr[1]
        k = np.array(key, np.uint32)
        lo = bool(prng.keep_mask(k, (1,), float(u), dev, offset=off)[0])
        hi = bool(prng.keep_mask(k, (1,), float(above), dev, offset=off)[0])
        if lo or not hi:
            raise AssertionError(f"threefry kernel at {key} {ctr}: masks "
                                 f"{lo}, {hi} at u = {u}")
    key = prng.fold_in(prng.prng_key(SEED + 8), 3)
    cases = [((1,), 0.9, 0), ((1000003,), 0.9, 0), ((8, 128, 768), 0.9, 0),
             ((20, 35, 1500), 0.35, 0), ((333,), 0.35, 2 ** 32 - 100),
             ((4097,), 0.5, 3 * 2 ** 32 + 5)]
    for shape, p, off in cases:
        before = prng.LAUNCHES
        got = prng.keep_mask(key, shape, p, dev, offset=off)
        if prng.LAUNCHES != before + 1:
            raise AssertionError("threefry: not one launch a mask")
        bits_equal(got, prng.keep_mask_plain(key, shape, p, dev, off),
                   f"threefry {shape} offset {off}")
    torch.cuda.synchronize()
    emit({"phase": "threefry", "known_answers": len(THREEFRY_KAT),
          "cases": [list(c[0]) + [c[1], c[2]] for c in cases],
          "bit_equal": True})
    timings = {}
    for form, shape in THREEFRY_FORMS.items():
        n = int(np.prod(shape))
        rec = {"shape": list(shape), "bound_ms": threefry_bound_ms(n),
               "kernel": timing(lambda: prng.keep_mask(key, shape, 0.9, dev),
                                THREEFRY_LAUNCHES),
               "plain": timing(lambda: prng.keep_mask_plain(key, shape, 0.9,
                                                            dev))}
        timings[form] = rec
        emit({"phase": "kernel_times", "form": form, "n": n, **rec})
    return timings


def site_masks_equal(hashes, rng, shapes, keep_prob: float, dev) -> int:
    """Every dropout site's keep mask of one apply under ``rng`` (the
    sites' ``hashes``, each mask's shape in ``shapes``) on the card and
    on the CPU, bit-equal; returns the sites checked."""
    from oktopk_tpu_torch.models.layers import SiteKeys
    from oktopk_tpu_torch.ops import prng
    keys = SiteKeys(rng, hashes).keys
    if len(keys) != len(shapes):
        raise AssertionError(f"{len(keys)} sites, {len(shapes)} shapes")
    for i, (k, shape) in enumerate(zip(keys, shapes)):
        bits_equal(prng.keep_mask(k, shape, keep_prob, dev).cpu(),
                   prng.keep_mask(k, shape, keep_prob), f"site {i} mask")
    return len(keys)


ZOO = ["resnet20", "resnet56", "resnet110", "resnet50", "alexnet",
       "densenet100", "preresnet110", "resnext29", "caffe_cifar",
       "mnistnet"]
# the card's float32 error against the float64 result may be this many
# times the CPU's float32 error, plus this share of the largest element
ZOO_ERR_FACTOR, ZOO_ERR_FLOOR = 4.0, 1e-6


def flat_grad(model):
    import torch
    from oktopk_tpu_torch.models.layout import to_jax_layout
    return torch.cat([to_jax_layout(p.grad, lay).reshape(-1)
                      for _, p, lay in model.jax_leaves()])


def phase_zoo_parity(dev):
    """Every CNN of the zoo at full width, from the same weights (PyTorch's
    default init under one seed, made on the CPU) and the same two images
    (224 x 224 for resnet50, 28 x 28 for mnistnet, 32 x 32 otherwise), in
    train mode: the logits and the flat gradient of a weighted sum of the
    logits, in JAX leaf order, in float32 on the card (TF32 off) and on
    the CPU, and in float64 on the CPU. A float32 gradient of these nets
    at batch 2 is ill-conditioned: BatchNorm's variance as E[x^2] -
    E[x]^2 over two images cancels, and deep stacks of it magnify the
    rounding (H19; resnet110's CPU float32 gradient is ~0.7% of its
    largest element off the float64 one). So the card is held to the
    float64 result as closely as the CPU's float32 is: its error within
    ``ZOO_ERR_FACTOR`` times the CPU's plus ``ZOO_ERR_FLOOR`` of the
    largest element, for the logits and for the gradient. Then
    ResNeXt-29's fwd/bwd (grouped convolutions under deterministic cuDNN)
    repeats bit for bit on the card."""
    import numpy as np
    import torch
    from oktopk_tpu_torch.models import create_model
    from oktopk_tpu_torch.models.registry import IMAGE_SHAPES

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    out = {}
    for dnn in ZOO:
        torch.manual_seed(SEED)
        cpu = create_model(dnn)
        models = {"cpu": cpu}
        for where, dtype in ((dev, torch.float32), ("cpu", torch.float64)):
            m = create_model(dnn)
            m.load_state_dict(cpu.state_dict())
            models[f"{where}_{dtype}"] = m.to(where, dtype)
        rng = np.random.RandomState(SEED)
        x = torch.from_numpy(rng.randn(2, *IMAGE_SHAPES[dnn])
                             .astype(np.float32))
        classes = 1000 if dnn == "resnet50" else 10
        w = torch.from_numpy(rng.randn(2, classes).astype(np.float32))
        res = {}
        for where, m in models.items():
            p = m.Dense_0.weight
            y = m(x.to(p.device, p.dtype), train=True)
            (y * w.to(p.device, p.dtype)).sum().backward()
            res[where] = (y.detach().cpu().double(),
                          flat_grad(m).cpu().double())
        (yc, gc), (yg, gg), (y64, g64) = res.values()
        err = {"n": int(g64.numel()),
               "logits_largest": float(y64.abs().max()),
               "grad_largest": float(g64.abs().max())}
        for nm, (a, b) in {"card_vs_cpu": ((yg, gg), (yc, gc)),
                           "card_vs_f64": ((yg, gg), (y64, g64)),
                           "cpu_vs_f64": ((yc, gc), (y64, g64))}.items():
            err[nm] = {"logits": float((a[0] - b[0]).abs().max()),
                       "grad": float((a[1] - b[1]).abs().max())}
        out[dnn] = err
        emit({"phase": "zoo_parity", "model": dnn, **err})
        if not (torch.isfinite(yg).all() and torch.isfinite(gg).all()):
            raise AssertionError(f"zoo_parity {dnn}: non-finite output")
        for f in ("logits", "grad"):
            limit = (ZOO_ERR_FACTOR * err["cpu_vs_f64"][f]
                     + ZOO_ERR_FLOOR * err[f"{f}_largest"])
            if err["card_vs_f64"][f] > limit:
                raise AssertionError(f"zoo_parity {dnn} {f}: the card is "
                                     f"{err['card_vs_f64'][f]} off float64, "
                                     f"over {limit}: {err}")
        del models, cpu
    torch.cuda.empty_cache()
    m = create_model("resnext29").to(dev)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))

    def fwd_bwd():
        for p in m.parameters():
            p.grad = None
        m(x.to(dev), train=True, update_stats=False).sum().backward()
        return flat_grad(m).clone()

    repeats = bool(torch.equal(fwd_bwd(), fwd_bwd()))
    if not repeats:
        raise AssertionError("zoo_parity: resnext29's fwd/bwd does not "
                             "repeat under deterministic cuDNN")
    emit({"phase": "zoo_parity_summary", "models": len(out),
          "tolerance": {"factor_of_cpu_float32_error": ZOO_ERR_FACTOR,
                        "floor_of_largest": ZOO_ERR_FLOOR},
          "resnext29_grouped_fwd_bwd_repeats": repeats})
    del m
    torch.cuda.empty_cache()
    return out


RESNET50_ARGV = ["--dnn", "resnet50", "--dataset", "imagenet",
                 "--batch-size", "32", "--density", "0.02",
                 "--warmup-steps", "1"]


def phase_resnet50_trainer(dev, steps: int = 5):
    """The slice at full width through ``main_trainer.build_trainer``
    (``--dnn resnet50 --dataset imagenet --batch-size 32 --num-workers 4
    --density 0.02``): P = 4 workers stacked on the card, global batch
    128 of 224 x 224 images (synthetic: no ImageNet file), SGD, bf16
    wire; one dense warmup step, four oktopk steps; run twice from one
    seed, with the verdict whether losses, volumes and parameters repeat
    bit for bit; then one more oktopk step under the profiler (launches
    and device time a step). Returns the first run's launches."""
    runs = [trainer_run(dev, RESNET50_ARGV, steps, "resnet50_trainer",
                        profile=i == 0) for i in range(2)]
    first = runs[0]
    if first["n"] != N_RESNET50:
        raise AssertionError(f"resnet50 has {first['n']} parameters")
    sparse = first["recs"][1:]
    for r in sparse:
        if r["comm_volume"] <= 0:
            raise AssertionError(f"resnet50_trainer step {r['step']}: "
                                 "volume 0")
    assert_launched(first["launches"], SPARSE_KERNELS, "resnet50_trainer")
    keys = ("loss", "comm_volume", "wire_bytes", "local_k", "global_k")
    differ = [{"step": a["step"], **{k: [a[k], b[k]] for k in keys
                                     if a[k] != b[k]}}
              for a, b in zip(first["recs"], runs[1]["recs"])
              if any(a[k] != b[k] for k in keys)]
    same = not differ and first["params_sha1"] == runs[1]["params_sha1"]
    emit({"phase": "resnet50_trainer_summary", "model": "resnet50",
          "n": first["n"], "k": first["k"], "workers": 4,
          "batch_per_worker": 32, "image": 224, "density": 0.02,
          "steps": steps, "build_s": first["build_s"],
          "losses": [r["loss"] for r in first["recs"]],
          "volume": [r["comm_volume"] for r in first["recs"]],
          "local_k": [r["local_k"] for r in first["recs"]],
          "global_k": [r["global_k"] for r in first["recs"]],
          "wire_bytes": [r["wire_bytes"] for r in first["recs"]],
          "step_ms": [r["ms"] for r in first["recs"]],
          "oktopk_steps": split_summary(sparse),
          "predicted_steps": split_summary(sparse[1:]),
          "dense_step": {k: first["recs"][0][k] for k in (
              "ms", "fwd_bwd_ms", "collective_ms", "optimizer_ms")},
          "calls_per_oktopk_step": [
              {"fused_select": r["fused_select_calls"],
               "compaction": r["compaction_calls"]} for r in sparse],
          "profiled_step": first["profiled"],
          "launches": first["launches"],
          "max_memory_allocated_gb": first["max_memory_allocated_gb"],
          "second_run_step_ms": [r["ms"] for r in runs[1]["recs"]],
          "repeats_bit_equal": {
              "losses_and_volumes": not differ,
              "params": first["params_sha1"] == runs[1]["params_sha1"]},
          "differ": differ})
    if not same:
        raise AssertionError(f"resnet50_trainer: two runs from one seed "
                             f"differ: {differ}")
    return first["launches"]


# ---- bfloat16 compute (slice 10) ----------------------------------------

# name: (registry name, train). The families with BatchNorm also run on
# their running statistics (``_running``, train=False): in train mode
# the gradient passes through the batch statistics' backward, where it
# cancels and bfloat16's own distance from float32 is a third of the
# largest element (ROADMAP.md, H21), too wide a yardstick to tell much.
BF16_FAMILIES = {
    "mnistnet": ("mnistnet", True),
    "resnet20": ("resnet20", True),
    "resnet20_running": ("resnet20", False),
    "bert_tiny": ("bert_tiny", True),
    "lstman4_tiny": ("lstman4_tiny", True),
    "lstman4_tiny_running": ("lstman4_tiny", False),
    "lstm_tiny": ("lstm_tiny", True),
}
# the card's bfloat16 may lie this many times the card's own bfloat16
# distance from its float32 (d_ref) away from the CPU's bfloat16
BF16_PARITY_FACTOR = 1.0
BF16_VGG_ARGV = ["--dnn", "vgg16", "--batch-size", "16", "--density",
                 "0.02", "--warmup-steps", "1", "--lr", "0.01"]
BF16_RUNS = {}           # bf16_trainer's bfloat16 runs, for bf16_cli


def bf16_inputs(dnn: str, rng):
    """(inputs, output weights) of ``dnn`` at a narrow batch, numpy."""
    import numpy as np
    from oktopk_tpu_torch.models.registry import IMAGE_SHAPES
    if dnn == "bert_tiny":
        ids = rng.randint(0, 1024, (4, 32)).astype(np.int32)
        am = np.ones((4, 32), np.int32)
        am[1, 20:] = 0
        xs = (ids, rng.randint(0, 2, (4, 32)).astype(np.int32), am)
        return xs, [rng.randn(4, 32, 1024).astype(np.float32),
                    rng.randn(4, 2).astype(np.float32)]
    if dnn == "lstman4_tiny":
        return ((rng.randn(2, 161, 101, 1).astype(np.float32),),
                [rng.randn(2, 51, 29).astype(np.float32)])
    if dnn == "lstm_tiny":
        return ((rng.randint(0, 1024, (4, 35)).astype(np.int32),),
                [rng.randn(4, 35, 1024).astype(np.float32)])
    return ((rng.randn(4, *IMAGE_SHAPES[dnn]).astype(np.float32),),
            [rng.randn(4, 10).astype(np.float32)])


def bf16_fwd_bwd(dnn: str, sd, dtype, where, xs, ws, train: bool = True):
    """The logits and the flat gradient (JAX leaf order) of a weighted
    sum of the logits, float64 on the host, of ``dnn`` in ``dtype`` on
    ``where`` from the state_dict ``sd``, no dropout; ``train`` False
    runs BatchNorm on its running statistics."""
    import torch
    from oktopk_tpu_torch.models import create_model
    kw = {"dropout": 0.0} if dnn == "bert_tiny" else {}
    m = create_model(dnn, dtype=dtype, **kw)
    m.load_state_dict(sd)
    m.to(where)
    out = m(*[torch.from_numpy(a).to(where) for a in xs], train=train)
    out = out if isinstance(out, tuple) else (out,)
    if any(o.dtype != torch.float32 for o in out):
        raise AssertionError(f"bf16_parity {dnn}: logits not float32")
    sum((o * torch.from_numpy(w).to(where)).sum()
        for o, w in zip(out, ws)).backward()
    leaves = [(path, p.numel()) for path, p, _ in m.jax_leaves()]
    return (torch.cat([o.detach().reshape(-1) for o in out]).cpu().double(),
            flat_grad(m).cpu().double(), leaves)


def phase_bf16_parity(dev):
    """Each family at narrow width (``BF16_FAMILIES``) from one seed's
    weights, made on the CPU, and the same inputs, no dropout: the logits
    and the flat gradient of a weighted sum of the logits in bfloat16 on
    the card against bfloat16 on the CPU, held to ``BF16_PARITY_FACTOR``
    times the card's d_ref = max|card bf16 - card f32| / max|card f32|
    (bfloat16's own distance from float32); the card's bfloat16 once
    more with cuBLAS allowed to reduce in bfloat16
    (``allow_bf16_reduced_precision_reduction``), its distance from the
    CPU beside."""
    import numpy as np
    import torch
    from oktopk_tpu_torch.models import create_model

    matmul = torch.backends.cuda.matmul
    bf16, f32 = torch.bfloat16, torch.float32
    out = {}
    for name, (dnn, train) in BF16_FAMILIES.items():
        torch.manual_seed(SEED)
        kw = {"dropout": 0.0} if dnn == "bert_tiny" else {}
        base = create_model(dnn, **kw)
        if hasattr(base, "init_weights"):
            base.init_weights(torch.Generator().manual_seed(SEED))
        sd = base.state_dict()
        xs, ws = bf16_inputs(dnn, np.random.RandomState(SEED))
        res = {}
        for tag, where, dt, reduced in (
                ("cpu_bf16", "cpu", bf16, False),
                ("card_f32", dev, f32, False),
                ("card_bf16", dev, bf16, False),
                ("card_bf16_reduced", dev, bf16, True)):
            matmul.allow_bf16_reduced_precision_reduction = reduced
            res[tag] = bf16_fwd_bwd(dnn, sd, dt, where, xs, ws, train)
        matmul.allow_bf16_reduced_precision_reduction = False
        err = {}
        diff = (res["card_bf16"][1] - res["cpu_bf16"][1]).abs()
        at, leaf = int(diff.argmax()), None
        for path, size in res["cpu_bf16"][2]:
            if at < size:
                leaf = path
                break
            at -= size
        for i, f in enumerate(("logits", "grad")):
            scale = float(res["card_f32"][i].abs().max())
            d = lambda a, b: float((res[a][i] - res[b][i]).abs().max()) \
                / scale
            err[f] = {"d_ref": d("card_bf16", "card_f32"),
                      "card_vs_cpu": d("card_bf16", "cpu_bf16"),
                      "reduced_vs_cpu": d("card_bf16_reduced", "cpu_bf16"),
                      "reduced_vs_card": d("card_bf16_reduced",
                                           "card_bf16")}
            err[f]["ratio"] = err[f]["card_vs_cpu"] / err[f]["d_ref"]
        out[name] = err
        emit({"phase": "bf16_parity", "model": name, "train": train, **err,
              "grad_card_vs_cpu_largest_at": leaf})
        for f, e in err.items():
            if not (0 < e["d_ref"] < 1) or not all(
                    math.isfinite(v) for v in e.values()):
                raise AssertionError(f"bf16_parity {name} {f}: {e}")
            if e["card_vs_cpu"] > BF16_PARITY_FACTOR * e["d_ref"]:
                raise AssertionError(
                    f"bf16_parity {name} {f}: the card's bfloat16 is "
                    f"{e['card_vs_cpu']} off the CPU's, over "
                    f"{BF16_PARITY_FACTOR} x d_ref {e['d_ref']}")
    emit({"phase": "bf16_parity_summary", "models": len(out),
          "factor_of_d_ref": BF16_PARITY_FACTOR})
    torch.cuda.empty_cache()
    return out


# cuDNN's and cuBLAS's product kernels (convolutions, their layout
# transposes, GEMMs), by name
PRODUCT_KEYS = ("conv", "wgrad", "dgrad", "fprop", "implicit", "gemm",
                "xmma", "cutlass", "nhwcToNchw", "nchwToNhwc")


def device_split(by_op: dict) -> dict:
    """A profiled step's device ms by kind of kernel: products (the
    convolutions with cuDNN's layout transposes, and GEMMs), elementwise
    passes, reductions, the rest."""
    split = {"products": 0.0, "elementwise": 0.0, "reduce": 0.0,
             "other": 0.0}
    for name, ms in by_op.items():
        if any(k in name for k in PRODUCT_KEYS):
            split["products"] += ms
        elif "elementwise" in name:
            split["elementwise"] += ms
        elif "reduce" in name:
            split["reduce"] += ms
        else:
            split["other"] += ms
    return split


def conv_flops(model, x) -> float:
    """The convolutions' floating-point operations in one training step on
    the batch ``x``: each convolution's forward 2 x MACs, its weight
    gradient the same, its input gradient the same but for the stem's
    (the images need none)."""
    import torch
    fwd = []

    def hook(m, i, o):
        k = m.weight
        fwd.append(2.0 * o.numel() * k[0].numel())

    hs = [m.register_forward_hook(hook) for m in model.modules()
          if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model(x, train=True, update_stats=False)
    for h in hs:
        h.remove()
    return 3.0 * sum(fwd) - fwd[0]


def run_line(run) -> dict:
    """A ``trainer_run``'s oktopk steps (all but the dense first):
    medians and spread, peak memory, the profiled step's device launches
    and time, every step's loss."""
    sparse = run["recs"][1:]

    def med(key):
        return statistics.median(r[key] for r in sparse)
    prof = run["profiled"] or {}
    return {"median_oktopk_step_ms": med("ms"),
            "spread_oktopk_step_ms": [min(r["ms"] for r in sparse),
                                      max(r["ms"] for r in sparse)],
            "fwd_bwd_ms": med("fwd_bwd_ms"),
            "collective_ms": med("collective_ms"),
            "optimizer_ms": med("optimizer_ms"),
            "max_memory_allocated_gb": run["max_memory_allocated_gb"],
            "device_launches_per_step": prof.get("device_launches"),
            "device_ms_per_step": prof.get("device_ms"),
            "losses": [r["loss"] for r in run["recs"]]}


def memorize(trainer, data, steps: int = 4) -> list:
    """``steps`` more steps on one batch, repeated: the losses, which must
    fall on a batch the model sees again (the synthetic labels are drawn
    anew for each batch, so over fresh batches the loss only wanders)."""
    b = next(data)
    return [float(trainer.train_step(b)["loss"]) for _ in range(steps)]


def check_bf16_run(run, name: str, falling: bool = True) -> None:
    """Finite losses, falling on a repeated batch (``memorize``, the last
    below the first) unless ``falling`` is False, K1 and the compaction
    launched, every oktopk step's volume above 0."""
    losses = [r["loss"] for r in run["recs"]]
    mem = run["after"]["memorize"]
    if not all(math.isfinite(x) for x in losses + mem) or \
            (falling and not mem[-1] < mem[0]):
        raise AssertionError(f"bf16_trainer {name}: losses {losses}, on a "
                             f"repeated batch {mem}")
    assert_launched(run["launches"], SPARSE_KERNELS, f"bf16_trainer {name}")
    for r in run["recs"][1:]:
        if r["comm_volume"] <= 0:
            raise AssertionError(f"bf16_trainer {name} step {r['step']}: "
                                 "volume 0")


def bert_reduction_turns(trainer, data, turns: int) -> dict:
    """``turns`` rounds of four steps with cuBLAS's bfloat16 reduction
    allowed, not, not, allowed: the fwd/bwd ms (CUDA events) of each."""
    import torch
    matmul = torch.backends.cuda.matmul
    clock = StepClock(trainer)
    ab = {"reduced": [], "float32": []}
    for _ in range(turns):
        for mode in ("reduced", "float32", "float32", "reduced"):
            matmul.allow_bf16_reduced_precision_reduction = \
                mode == "reduced"
            b = next(data)
            clock.mark("start")
            trainer.train_step(b)
            clock.mark("end")
            torch.cuda.synchronize()
            ab[mode].append(clock.split()["fwd_bwd_ms"])
    matmul.allow_bf16_reduced_precision_reduction = False
    trainer.grad_step = clock.inner
    return {k: {"median": statistics.median(v), "all": v}
            for k, v in ab.items()}


BF16_CONFIGS = {
    # model: (argv, steps: one dense and the rest oktopk but for BERT and
    # the PTB LSTM, whose first step is the exact recompute)
    "vgg16": (BF16_VGG_ARGV, 6),
    "resnet50": (RESNET50_ARGV + ["--lr", "0.01"], 5),
    "bert_base": (["--model", "bert_base", "--lr", "2e-5"], 5),
    "lstman4": (LSTMAN4_ARGV, 5),
    # the written-out cell's cost (H22); at the uniform loss from the
    # start, so its losses are reported, not held to fall
    "lstm": (["--dnn", "lstm", "--dataset", "ptb", "--batch-size", "20",
              "--lr", "1.0", "--density", "0.02", "--warmup-steps", "0"],
             3),
}


def phase_bf16_trainer(dev) -> dict:
    """bfloat16 compute at full width, P = 4 stacked on the card, each
    model beside float32 in the same configuration and call
    (``BF16_CONFIGS``): VGG-16 (global batch 64, d = 0.02, bf16 wire,
    one dense and five oktopk steps); ResNet-50 (``--batch-size 32``,
    224 x 224, d = 0.02, one dense and four oktopk steps; bfloat16 twice
    from one seed, bit for bit); BERT-base (``main_bert.build_trainer
    --compute-dtype bfloat16``, bs 8, seq 128, dropout 0.1, d = 0.01,
    five steps; then cuBLAS's bfloat16 reduction allowed and not, in
    turns); DeepSpeech (``lstman4``, bs 2, d = 0.02, clip 400, one dense
    and four oktopk steps); the PTB LSTM (bs 20, d = 0.02, three steps:
    the written-out cell's cost, H22). Each run: the split of its steps,
    peak memory, finite losses (but the PTB LSTM's, falling over four
    more steps on one repeated batch, eight for BERT-base, ``memorize``),
    K1 and the compaction launched, and one
    profiled step (device launches and time); ResNet-50's
    profiled steps split into convolutions (their TFLOP/s), elementwise
    passes and reductions (the written-out BatchNorm's, and the casts').
    Returns {path: launches} of the bfloat16 runs."""
    import torch
    from oktopk_tpu_torch.models import create_model
    from oktopk_tpu_torch.train import main_bert

    by_path = {}
    for model, (argv, steps) in BF16_CONFIGS.items():
        runs = {}
        for dt in ("float32", "bfloat16", "bfloat16 again"):
            if dt == "bfloat16 again" and model != "resnet50":
                continue
            full = argv + ["--compute-dtype", dt.split()[0]]
            build = None
            if model == "bert_base":
                # BertAdam's schedule over 100 steps: the memorizing
                # steps after the run still move the weights
                build = lambda: main_bert.build_trainer(main_bert.parse_args(
                    full + ["--num-workers", "4", "--seed", str(SEED),
                            "--device", str(dev), "--num-minibatches",
                            "100"]))
            turns = model == "bert_base" and dt == "bfloat16"
            after = None if dt == "bfloat16 again" else (
                lambda tr, data, turns=turns: {
                "reduction_turns": (bert_reduction_turns(tr, data, 2)
                                    if turns else None),
                "memorize": memorize(tr, data,
                                     8 if model == "bert_base" else 4)})
            runs[dt] = trainer_run(dev, full, steps,
                                   f"bf16_trainer_{model}_{dt[:8]}",
                                   profile=dt != "bfloat16 again",
                                   build=build, after=after)
        bf = runs["bfloat16"]
        check_bf16_run(bf, model, falling=model != "lstm")
        if bf["dtype"] != "torch.bfloat16" or \
                runs["float32"]["dtype"] != "None":
            raise AssertionError(f"bf16_trainer {model}: compute dtypes "
                                 f"{bf['dtype']}, {runs['float32']['dtype']}")
        by_path[f"{model} bf16"] = bf["launches"]
        line = {dt: run_line(runs[dt]) for dt in ("float32", "bfloat16")}
        if model == "resnet50":
            again = runs["bfloat16 again"]
            same = bf["params_sha1"] == again["params_sha1"] and all(
                a[k] == b[k] for a, b in zip(bf["recs"], again["recs"])
                for k in ("loss", "comm_volume", "wire_bytes"))
            if not same:
                raise AssertionError("bf16_trainer resnet50: two runs from "
                                     "one seed differ")
            m = create_model("resnet50").to(dev)
            flops = conv_flops(m, torch.zeros(1, 224, 224, 3,
                                              device=dev)) * 128
            del m
            line.update(conv_tflop_per_step=flops / 1e12,
                        repeats_bit_equal=same)
            for dt in ("float32", "bfloat16"):
                prof = runs[dt]["profiled"]
                line[dt].update(
                    busy_share=prof["device_ms"]
                    / line[dt]["median_oktopk_step_ms"],
                    by_kind_ms=prof["by_kind_ms"], top_ms=prof["top_ms"],
                    conv_tflops=flops / (prof["by_kind_ms"]["products"]
                                         * 1e-3) / 1e12)
        for dt in ("float32", "bfloat16"):
            line[dt]["losses_on_a_repeated_batch"] = \
                runs[dt]["after"]["memorize"]
        if model == "bert_base":
            line["bf16_reduction_fwd_bwd_ms"] = \
                bf["after"]["reduction_turns"]
        emit({"phase": "bf16_trainer_summary", "model": model,
              "steps": steps, "argv": argv, **line})
        BF16_RUNS[model] = bf
        torch.cuda.empty_cache()
    return by_path


def phase_bf16_cli(dev):
    """``python -m oktopk_tpu_torch.train.main_trainer --dnn vgg16
    --num-workers 4 --warmup-steps 1 --max-iters 3 --compute-dtype
    bfloat16`` in its own process: exit 0, and its logged last loss and
    volume equal to bf16_trainer's third VGG-16 step (deterministic
    cuDNN and cuBLAS: equal, not near)."""
    cmd = [sys.executable, "-m", "oktopk_tpu_torch.train.main_trainer",
           "--device", str(dev), "--num-workers", "4", "--max-iters", "3",
           "--compute-dtype", "bfloat16"] + BF16_VGG_ARGV
    t0 = time.perf_counter()
    rc, out = run_cli(cmd, 300)
    secs = time.perf_counter() - t0
    done = re.search(r"done: 3 iterations, loss (\S+), vol/step (\d+)", out)
    if rc != 0 or done is None:
        raise AssertionError(f"bf16_cli: exit {rc}\n{out[-4000:]}")
    cli = {"loss": float(done.group(1)), "comm_volume": int(done.group(2))}
    ref = BF16_RUNS["vgg16"]["recs"][2]
    ref = {"loss": ref["loss"], "comm_volume": int(ref["comm_volume"])}
    if cli != ref:
        raise AssertionError(f"bf16_cli: last step {cli}, bf16_trainer's "
                             f"third VGG-16 step {ref}")
    emit({"phase": "bf16_cli", "cmd": " ".join(cmd[1:]), "exit": rc,
          "seconds": secs, "last_step": cli,
          "equal_to_bf16_trainer": True})

def write_cifar10(root: str, n: int = 64, seed: int = 0) -> None:
    """A small ``cifar-10-batches-py`` (torchvision's pickle layout)."""
    import pickle

    import numpy as np
    rng = np.random.RandomState(seed)
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": rng.randint(0, 256, (n, 3072), dtype=np.uint8),
             b"labels": rng.randint(0, 10, n).tolist()}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(d, f)


def write_mnist(root: str, n: int = 96, seed: int = 0) -> None:
    """Small MNIST idx files."""
    import numpy as np
    rng = np.random.RandomState(seed)
    for prefix in ("train", "t10k"):
        with open(os.path.join(root, f"{prefix}-images-idx3-ubyte"),
                  "wb") as f:
            f.write(b"\0" * 16 + rng.randint(0, 256, n * 784,
                                            dtype=np.uint8).tobytes())
        with open(os.path.join(root, f"{prefix}-labels-idx1-ubyte"),
                  "wb") as f:
            f.write(b"\0" * 8 + rng.randint(0, 10, n,
                                           dtype=np.uint8).tobytes())


def phase_loader_cli(dev, steps: int = 3):
    """``main_trainer`` on files the script writes into a temporary
    directory: ``--dnn resnet20 --dataset cifar10 --data-dir ...`` and
    ``--dnn mnistnet --dataset mnist``, P = 4 stacked on the card, three
    steps each (one dense warmup step), ``meta["synthetic"]`` False; then
    ``--dataset imagenet`` where there is no file: it logs the synthetic
    warning and trains one step."""
    import logging
    import shutil
    import tempfile

    import torch
    from oktopk_tpu_torch.train import main_trainer

    root = tempfile.mkdtemp(prefix="oktopk_loader_cli_")
    try:
        write_cifar10(root)
        write_mnist(root)
        out = {}
        for dnn, dataset in (("resnet20", "cifar10"), ("mnistnet", "mnist")):
            args = main_trainer.parse_args([
                "--dnn", dnn, "--dataset", dataset, "--data-dir", root,
                "--device", str(dev), "--num-workers", "4", "--batch-size",
                "4", "--max-iters", str(steps), "--warmup-steps", "1",
                "--seed", str(SEED)])
            trainer, data, _, meta = main_trainer.build_trainer(args)
            if meta["synthetic"]:
                raise AssertionError(f"loader_cli {dataset}: synthetic data "
                                     f"with the files in {root}")
            m = trainer.train(data, steps, log_every=steps)
            if not math.isfinite(m["loss"]):
                raise AssertionError(f"loader_cli {dnn}: loss {m['loss']}")
            out[dataset] = {"dnn": dnn, "meta": meta, "loss": m["loss"],
                            "comm_volume": m["comm_volume"]}
            del trainer
        empty = os.path.join(root, "no_imagenet")
        os.makedirs(empty)
        records = []
        handler = logging.Handler(logging.WARNING)
        handler.emit = records.append
        logger = logging.getLogger("oktopk_tpu_torch")
        logger.addHandler(handler)
        try:
            rc = main_trainer.main([
                "--dnn", "resnet50", "--dataset", "imagenet", "--data-dir",
                empty, "--device", str(dev), "--num-workers", "1",
                "--batch-size", "2", "--max-iters", "1", "--warmup-steps",
                "1"])
        finally:
            logger.removeHandler(handler)
        warned = [r.getMessage() for r in records
                  if "using synthetic data" in r.getMessage()]
        if rc != 0 or not warned:
            raise AssertionError(f"loader_cli imagenet without a file: rc "
                                 f"{rc}, warnings {warned}")
        out["imagenet"] = {"synthetic_warning": warned[0]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    emit({"phase": "loader_cli", **out})
    return out


# ---- the train surface (slice 9): files, checkpoints, preemption, eval --

N_VOCAB_BASE = 30522         # BERT-base's embedding rows: the vocab written
SLICE9_SYLLABLES = ("ka", "lo", "mi", "ne", "ru", "sa", "ti", "vo", "ze",
                    "pa", "gu", "be", "do", "fi", "ho", "ja")
SLICE9_DEADLINE_S = 420      # a CLI run that hangs fails the phase


def slice9_words():
    """Two- and three-syllable words; the vocabulary holds every other
    one whole, and every syllable as a word start and as a ``##`` piece,
    so WordPiece splits the rest."""
    s = SLICE9_SYLLABLES
    return ([a + b for a in s for b in s]
            + [a + b + c for a in s[:8] for b in s for c in s[:6]])


def write_corpus(root: str, n_docs: int = 100, seed: int = SEED) -> dict:
    """``root/wikipedia/part-0.txt`` (sentence per line, blank line
    between documents, some accented and capitalised words) and
    ``root/vocab.txt`` of exactly ``N_VOCAB_BASE`` entries."""
    import numpy as np
    rng = np.random.RandomState(seed)
    words = slice9_words()
    docs = []
    for _ in range(n_docs):
        sents = []
        for _ in range(rng.randint(3, 7)):
            ws = [words[i] for i in rng.randint(0, len(words),
                                                rng.randint(4, 15))]
            ws[0] = ws[0].capitalize()
            if rng.rand() < 0.3:
                ws[-1] = ws[-1].replace("e", "é")
            sents.append(" ".join(ws) + rng.choice([".", "!", "?", ","]))
        docs.append("\n".join(sents))
    os.makedirs(os.path.join(root, "wikipedia"), exist_ok=True)
    with open(os.path.join(root, "wikipedia", "part-0.txt"), "w",
              encoding="utf-8") as f:
        f.write("\n\n".join(docs) + "\n")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", "!", "?",
             ",", "'"]
    vocab += list(SLICE9_SYLLABLES) + ["##" + s for s in SLICE9_SYLLABLES]
    vocab += words[::2]
    vocab += [f"[unused{i}]" for i in range(N_VOCAB_BASE - len(vocab))]
    with open(os.path.join(root, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    return {"documents": n_docs, "vocab": len(vocab),
            "corpus_bytes": os.path.getsize(
                os.path.join(root, "wikipedia", "part-0.txt"))}


def median_ms(fn, reps: int = 5) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def phase_text_data(root: str) -> dict:
    """The corpus and vocabulary the slice trains on, then on the host:
    the native WordPiece tokenizer built with g++ and equal to the Python
    ``FullTokenizer`` on every corpus line and pair; the native prefetch
    ring and the Python batcher (``_batched`` under ``OKTOPK_NATIVE=0``)
    for two epochs each, every batch whole records and each epoch every
    record once (their shuffles differ by design; the ring's batches are
    held to the JAX package's ring by ``tests/test_torch_text_data.py``);
    host ms a batch of the pretraining iterator (native and Python
    tokenizer), of the ring and of the Python batcher."""
    import numpy as np
    from oktopk_tpu_torch import native
    from oktopk_tpu_torch.data import bert_pretrain, loaders, tokenization
    from oktopk_tpu_torch.native.loader import make_prefetch_iter
    from oktopk_tpu_torch.native.tokenizer import NativeTokenizer

    info = write_corpus(root)
    t0 = time.perf_counter()
    if not native.resolve("tokenizer"):
        raise AssertionError("OKTOPK_NATIVE=1 did not resolve to native")
    build_s = time.perf_counter() - t0
    vocab = os.path.join(root, "vocab.txt")
    nat, py = NativeTokenizer(vocab), tokenization.FullTokenizer(vocab)
    if nat.vocab_size != N_VOCAB_BASE:
        raise AssertionError(f"native tokenizer: vocab {nat.vocab_size}")
    lines = [ln for ln in open(os.path.join(root, "wikipedia",
                                            "part-0.txt"),
                               encoding="utf-8").read().split("\n") if ln]
    unk, pieces = 0, 0
    for ln in lines:
        ids = py.convert_tokens_to_ids(py.tokenize(ln))
        if nat.encode(ln) != ids:
            raise AssertionError(f"native tokenizer differs on {ln!r}")
        unk += ids.count(1)
        pieces += len(ids)
    for a, b in zip(lines, lines[1:]):
        if nat.encode_pair(a, b, 128) != py.encode_pair(a, b, 128):
            raise AssertionError(f"encode_pair differs on {a!r}, {b!r}")
    corpus = os.path.join(root, "wikipedia")
    its = {name: bert_pretrain.pretrain_iterator(corpus, tok, 32, 128,
                                                 seed=SEED)
           for name, tok in (("native", nat), ("python", py))}
    for _ in range(3):
        a, b = next(its["native"]), next(its["python"])
        for k in b:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"pretraining batch {k} differs by "
                                     "tokenizer")
    batch_ms = {name: median_ms(lambda it=it: next(it))
                for name, it in its.items()}
    x = {k: np.concatenate([next(its["native"])[k] for _ in range(8)])
         for k in ("input_ids", "nsp_labels")}
    n = len(x["nsp_labels"])
    x["index"] = np.arange(n, dtype=np.int32)
    ring = make_prefetch_iter(x, 32, seed=SEED)
    # the Python batcher shuffles by another rule than the ring, so the
    # two are held to the same contract, not to each other: every batch
    # whole records, each epoch every record once
    os.environ["OKTOPK_NATIVE"] = "0"
    try:
        python = loaders._batched(x, 32, SEED)
    finally:
        os.environ["OKTOPK_NATIVE"] = "1"
    per_epoch = n // 32
    for name, it in (("ring", ring), ("python", python)):
        seen = []
        for i in range(2 * per_epoch):
            a = next(it)
            for k in x:
                if not np.array_equal(a[k], x[k][a["index"]]):
                    raise AssertionError(f"{name} batch {i}: {k} is not "
                                         "its records'")
            seen.append(a["index"])
        for e in range(2):
            rows = np.sort(np.concatenate(seen[e * per_epoch:
                                               (e + 1) * per_epoch]))
            if not np.array_equal(rows, np.arange(n)):
                raise AssertionError(f"{name} epoch {e} is not every "
                                     "record once")
    ring_ms = median_ms(lambda: next(ring))
    python_ms = median_ms(lambda: next(python))
    out = {"phase": "text_data", **info, "lines": len(lines),
           "wordpieces": pieces, "unk": unk, "native_build_s": build_s,
           "native_equal_python": True,
           "ring_and_python_epochs_every_record_once": True,
           "python_batch_ms": python_ms,
           "pretrain_batch_ms": batch_ms, "ring_batch_ms": ring_ms,
           "batch": "32 x 128 (pretrain), 32 x 128 ids (ring)"}
    emit(out)
    return out


def slice9_env(state_dir: str) -> dict:
    env = dict(os.environ, OKTOPK_NATIVE="1", OKTOPK_STATE_DIR=state_dir,
               OKTOPK_RUN_ID="chip_smoke")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


BERT9_MODEL = "bert_base"
BERT9_ARGV = ["--model", BERT9_MODEL, "--num-workers", "4", "--batch-size",
              "8", "--max-seq-length", "128", "--density", "0.01",
              "--seed", str(SEED), "--log-every", "1"]
AN4_DNN = "lstman4"


def run_module(module: str, argv, env, timeout_s: float = SLICE9_DEADLINE_S):
    """``python -m module argv`` through ``run_cli``: (rc, output)."""
    return run_cli([sys.executable, "-m", module] + list(argv), timeout_s,
                   env)


def iter_lines(out: str):
    return [ln.split(" ", 2)[2] for ln in out.splitlines()
            if re.search(r" iter \d+ loss ", ln)]


def sha256(path: str) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{prefix}/{k}")
    elif tree is not None:
        yield prefix, tree


def trees_bit_equal(a, b, what: str) -> int:
    """Raise unless the two state trees hold the same leaves, bit for
    bit; returns the leaf count."""
    import numpy as np
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    if [p for p, _ in la] != [p for p, _ in lb]:
        raise AssertionError(f"{what}: the trees' leaves differ")
    for (p, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(
                x.reshape(-1).view(np.uint8), y.reshape(-1).view(np.uint8)):
            raise AssertionError(f"{what}: {p} differs")
    return len(la)


def phase_bert_ckpt(dev, root: str) -> dict:
    """BERT-base at full width through the ``main_bert`` CLI on the
    corpus (``meta["synthetic"]`` False), P = 4, bs 8, seq 128, d = 0.01,
    four steps, ``--ckpt-dir``; the file verified by its manifest and
    restored into a fresh full-width Trainer on the card, every leaf
    bit-equal to the file, one step from it with the counters set to 0
    just before and read just after; then two ``--resume`` runs of two
    more steps each, in new processes, whose logged losses and volumes
    and whose final files repeat bit for bit."""
    import torch
    from oktopk_tpu_torch.train import checkpoint as ckpt
    from oktopk_tpu_torch.train import durable, main_bert

    env = slice9_env(os.path.join(root, "state"))
    d = os.path.join(root, "bert_ckpt")
    t0 = time.perf_counter()
    rc, out = run_module("oktopk_tpu_torch.train.main_bert", BERT9_ARGV + [
        "--data-dir", root, "--num-minibatches", "4", "--ckpt-dir", d], env)
    run_s = time.perf_counter() - t0
    saved = re.search(r"checkpoint (\S+): (\d+) B in (\S+) s", out)
    if rc != 0 or saved is None or "synthetic" in out \
            or len(iter_lines(out)) != 4:
        raise AssertionError(f"main_bert --ckpt-dir: exit {rc}\n"
                             f"{out[-4000:]}")
    path = saved.group(1)
    t0 = time.perf_counter()
    v = durable.verify_checkpoint(path)
    verify_s = time.perf_counter() - t0
    if not v.ok or v.reason != "ok":
        raise AssertionError(f"bert_ckpt: {path} fails verification: "
                             f"{v.reason}")
    t0 = time.perf_counter()
    data = durable.read_file(path)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    durable.compute_digest(data)
    digest_s = time.perf_counter() - t0
    del data
    args = main_bert.parse_args(BERT9_ARGV + ["--data-dir", root,
                                              "--num-minibatches", "6",
                                              "--device", str(dev)])
    trainer, batches = main_bert.build_trainer(args)
    if args.data_meta["synthetic"]:
        raise AssertionError("bert_ckpt: the corpus was not read")
    t0 = time.perf_counter()
    tree, step = ckpt.restore_checkpoint(d, trainer.train_state(
        gather=False))
    restore_read_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.load_train_state(tree)
    torch.cuda.synchronize()
    restore_load_s = time.perf_counter() - t0
    leaves = trees_bit_equal(trainer.train_state(host=True),
                             ckpt.read_payload(path)["state"],
                             "bert_ckpt restore")
    del tree
    ckpt.clear_cache()
    torch.cuda.synchronize()
    zero_counts()
    m = trainer.train(batches, 1, start_step=step)
    torch.cuda.synchronize()
    launches = read_counts()
    assert_launched(launches, DROPOUT_KERNELS, "bert_ckpt resumed step")
    if not math.isfinite(m["loss"]):
        raise AssertionError(f"bert_ckpt: resumed loss {m['loss']}")
    del trainer, batches
    torch.cuda.empty_cache()
    resumes = []
    for i in range(2):
        out_dir = os.path.join(root, f"bert_resume{i}")
        t0 = time.perf_counter()
        rc, out = run_module("oktopk_tpu_torch.train.main_bert",
                             BERT9_ARGV + ["--data-dir", root,
                                           "--num-minibatches", "6",
                                           "--resume", d, "--ckpt-dir",
                                           out_dir], env)
        lines = iter_lines(out)
        done = re.search(r"done: loss (\S+) comm volume/step (\d+)", out)
        if rc != 0 or len(lines) != 2 or done is None \
                or "resumed at step 4" not in out:
            raise AssertionError(f"main_bert --resume: exit {rc}\n"
                                 f"{out[-4000:]}")
        resumes.append({"seconds": time.perf_counter() - t0,
                        "steps": [ln.rsplit(" ", 1)[0] for ln in lines],
                        "done": done.groups(),
                        "sha256": sha256(os.path.join(out_dir,
                                                      "ckpt-6.msgpack"))})
    a, b = resumes
    if (a["steps"], a["done"], a["sha256"]) != (b["steps"], b["done"],
                                                b["sha256"]):
        raise AssertionError(f"bert_ckpt: two resumes differ: {a} vs {b}")
    out = {"phase": "bert_ckpt", "model": BERT9_MODEL, "P": 4,
           "file": os.path.basename(path), "bytes": int(saved.group(2)),
           "leaves": leaves, "first_run_s": run_s,
           "save_s": float(saved.group(3)), "verify_s": verify_s,
           "read_s": read_s, "digest_s": digest_s,
           "restore_read_verify_decode_s": restore_read_s,
           "restore_to_card_s": restore_load_s, "restore_bit_equal": True,
           "resumed_step_loss": m["loss"], "launches": launches,
           "resumes_bit_identical": True, "resume_s": [r["seconds"]
                                                       for r in resumes],
           "resume_steps": a["steps"], "resume_done": a["done"],
           "final_sha256": a["sha256"][:16]}
    emit(out)
    return out


def phase_preempt(root: str) -> dict:
    """``main_bert --model bert_base ... --handle-preemption
    --num-minibatches 50`` in its own session; SIGUSR2 after its third
    logged step: it must exit with code 3 and park the state at the step
    it stopped; a second run with the flag resumes there, runs to step
    50, exits 0 and clears the parked state. The session is killed on a
    deadline: a hang fails the run."""
    import selectors
    import signal

    from oktopk_tpu_torch.train import checkpoint as ckpt
    from oktopk_tpu_torch.train import preemption

    state_dir = os.path.join(root, "state")
    env = slice9_env(state_dir)
    argv = BERT9_ARGV + ["--data-dir", root, "--num-minibatches", "50",
                         "--handle-preemption"]
    cmd = [sys.executable, "-m", "oktopk_tpu_torch.train.main_bert"] + argv
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env,
                         cwd=ROOT, start_new_session=True)
    lines, signalled_after = [], None
    sel = selectors.DefaultSelector()
    sel.register(p.stdout, selectors.EVENT_READ)
    deadline = time.monotonic() + SLICE9_DEADLINE_S
    try:
        while True:
            if time.monotonic() > deadline:
                raise AssertionError("preempt: the run did not end in "
                                     f"{SLICE9_DEADLINE_S} s")
            if not sel.select(timeout=1.0):
                continue
            line = p.stdout.readline()
            if not line:
                break
            lines.append(line.rstrip())
            steps = [ln for ln in lines if re.search(r" iter \d+ loss ", ln)]
            if signalled_after is None and len(steps) >= 3:
                os.kill(p.pid, signal.SIGUSR2)
                signalled_after = int(re.search(r" iter (\d+) ",
                                                steps[-1]).group(1))
        rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    stop_s = time.perf_counter() - t0
    out = "\n".join(lines)
    parked = re.search(r"preempted @ step (\d+): state parked at (\S+)",
                       out)
    if rc != 3 or parked is None or signalled_after is None:
        raise AssertionError(f"preempt: exit {rc} (want 3)\n{out[-4000:]}")
    stopped = int(parked.group(1))
    last = max(int(re.search(r" iter (\d+) ", ln).group(1))
               for ln in lines if re.search(r" iter \d+ loss ", ln))
    if stopped != last or ckpt.read_payload(
            parked.group(2), use_cache=False)["step"] != stopped:
        raise AssertionError(f"preempt: parked step {stopped}, last logged "
                             f"step {last}")
    t0 = time.perf_counter()
    rc, out2 = run_module("oktopk_tpu_torch.train.main_bert", argv, env)
    resume_s = time.perf_counter() - t0
    steps2 = iter_lines(out2)
    sub = preemption.interrupted_state_path(state_dir, "chip_smoke") + ".d"
    if (rc != 0 or f"resumed interrupted state at step {stopped}" not in out2
            or len(steps2) != 50 - stopped or os.path.isdir(sub)
            and os.listdir(sub)):
        raise AssertionError(f"preempt resume: exit {rc}, {len(steps2)} "
                             f"steps\n{out2[-4000:]}")
    res = {"phase": "preempt", "signal": "SIGUSR2",
           "signalled_after_step": signalled_after,
           "exit": 3, "parked_step": stopped, "stop_run_s": stop_s,
           "resume_exit": 0, "resumed_steps": len(steps2),
           "resume_run_s": resume_s, "parked_state_cleared": True}
    emit(res)
    return res


def write_mrpc(root: str, n_train: int = 64, n_dev: int = 32,
               seed: int = SEED) -> None:
    """MRPC-shaped TSVs (Quality, #1 ID, #2 ID, #1 String, #2 String):
    a paraphrase drops one word of the first sentence, a non-paraphrase
    is another sentence."""
    import numpy as np
    rng = np.random.RandomState(seed)
    words = slice9_words()

    def sentence():
        return " ".join(words[i] for i in rng.randint(0, len(words),
                                                      rng.randint(5, 16)))
    os.makedirs(root, exist_ok=True)
    for name, n in (("train.tsv", n_train), ("dev.tsv", n_dev)):
        rows = ["Quality\t#1 ID\t#2 ID\t#1 String\t#2 String"]
        for i in range(n):
            a = sentence()
            y = int(rng.rand() < 0.5)
            if y:
                ws = a.split()
                del ws[rng.randint(len(ws))]
                b = " ".join(ws)
            else:
                b = sentence()
            rows.append(f"{y}\t{2 * i}\t{2 * i + 1}\t{a}\t{b}")
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            f.write("\n".join(rows) + "\n")


def phase_glue_cli(dev, root: str) -> dict:
    """``glue --task mrpc --model bert_base --data-dir T/MRPC --vocab-file
    T/vocab.txt --ckpt D --epochs 1`` on TSVs the script writes: the
    grafted encoder bit-equal to the checkpoint's ``bert`` subtree (the
    head left as initialised), then the command line on the card with
    the counters set to 0 just before and read just after: finite loss,
    the metrics, exit 0."""
    import logging

    import torch
    from oktopk_tpu_torch.convert import bert_to_jax_params
    from oktopk_tpu_torch.data.tokenization import FullTokenizer
    from oktopk_tpu_torch.train import checkpoint as ckpt
    from oktopk_tpu_torch.train import glue

    mrpc = os.path.join(root, "MRPC")
    write_mrpc(mrpc)
    d = os.path.join(root, "bert_ckpt")
    argv = ["--task", "mrpc", "--model", BERT9_MODEL, "--data-dir", mrpc,
            "--vocab-file", os.path.join(root, "vocab.txt"), "--ckpt", d,
            "--epochs", "1", "--batch-size", "8", "--device", str(dev)]
    args = glue.parse_args(argv)
    model = glue.build_model(args, FullTokenizer(args.vocab_file))
    t0 = time.perf_counter()
    glue.graft_encoder(model, d)
    graft_s = time.perf_counter() - t0
    want = ckpt.read_payload(ckpt.latest_checkpoint(d))["state"]["params"]
    got = bert_to_jax_params(model.state_dict())
    leaves = trees_bit_equal(got["bert"], want["bert"], "glue graft")
    if "Dense_0" not in got or "bert" not in want:
        raise AssertionError("glue: the classifier's tree is not flax's")
    del model, got, want
    records = []
    handler = logging.Handler(logging.INFO)
    handler.emit = records.append
    logger = logging.getLogger("oktopk_tpu_torch.glue")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    try:
        rc = glue.main(argv)
    finally:
        logger.removeHandler(handler)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counts()
    ckpt.clear_cache()
    torch.cuda.empty_cache()
    msgs = [r.getMessage() for r in records]
    epoch = [m for m in msgs if m.startswith("epoch 0: train loss")]
    loss = (float(epoch[0].split()[4]) if epoch else float("nan"))
    if rc != 0 or not epoch or not math.isfinite(loss) \
            or "accuracy=" not in epoch[0] or "f1=" not in epoch[0]:
        raise AssertionError(f"glue CLI: exit {rc}, log {msgs}")
    assert_launched(launches, ("threefry",), "glue_cli")
    out = {"phase": "glue_cli", "task": "mrpc", "model": BERT9_MODEL,
           "train_rows": 64, "dev_rows": 32, "batch": 8,
           "graft_bit_equal": True, "encoder_leaves": leaves,
           "graft_s": graft_s, "cli_s": cli_s, "log": epoch[0],
           "launches": launches}
    emit(out)
    return out


def tone_wav(path: str, text: str, rng) -> None:
    """16 kHz PCM: each character a sine in its own 5-bin band (as the
    synthetic AN4 batches code it), 8 hops of 10 ms, over a little
    noise."""
    import wave

    import numpy as np
    from oktopk_tpu_torch.data import audio
    parts = []
    t = np.arange(8 * audio.HOP) / audio.SAMPLE_RATE
    for ch in text.upper():
        c = audio.AN4_LABELS.index(ch)
        parts.append(0.5 * np.sin(2 * np.pi * (c * 5 + 2) * 50.0 * t))
    x = np.concatenate(parts + [np.zeros(audio.WINDOW)])
    x = x + 0.01 * rng.randn(len(x))
    pcm = np.clip(x * 32767, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(audio.SAMPLE_RATE)
        w.writeframes(pcm.tobytes())


def write_an4(root: str, n: int = 16, seed: int = SEED) -> None:
    """``n`` tone-coded utterances of AN4-like words with their
    transcripts, and both manifests."""
    import numpy as np
    rng = np.random.RandomState(seed)
    words = ["YES", "NO", "ENTER", "ERASE", "RUBOUT", "STOP", "GO", "TWO",
             "SIX", "NINE"]
    os.makedirs(root, exist_ok=True)
    lines = []
    for i in range(n):
        text = " ".join(rng.choice(words, size=rng.randint(1, 4)))
        tone_wav(os.path.join(root, f"u{i}.wav"), text, rng)
        with open(os.path.join(root, f"u{i}.txt"), "w") as f:
            f.write(text)
        lines.append(f"u{i}.wav,u{i}.txt")
    for split in ("train", "val"):
        with open(os.path.join(root, f"an4_{split}_manifest.csv"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")


def phase_an4_eval(dev, root: str) -> dict:
    """``main_trainer --dnn lstman4 --dataset an4 --data-dir T
    --num-workers 4 --batch-size 2 --density 0.02 --grad-clip 400
    --max-iters 4 --ckpt-dir D --ckpt-every 4`` (one dense warmup step)
    on WAV files and manifests the script writes (``meta["synthetic"]``
    False), counters set to 0 just before and read just after; then
    ``evaluate --dnn lstman4 --dataset an4 --ckpt D`` on the card and on
    the CPU, two batches of two utterances: the CTC loss within 1e-4
    relative (lstman4_parity's tolerance, H18), the greedy hypotheses and
    WER/CER equal, or the count of differing hypotheses stated."""
    import logging

    import torch
    from oktopk_tpu_torch.data import make_dataset
    from oktopk_tpu_torch.train import checkpoint as ckpt
    from oktopk_tpu_torch.train import evaluate, main_trainer

    data_dir = os.path.join(root, "an4")
    write_an4(data_dir)
    d = os.path.join(root, "an4_ckpt")
    it, meta = make_dataset("an4", AN4_DNN, 8, path=data_dir)
    if meta["synthetic"]:
        raise AssertionError("an4_eval: the manifests were not read")
    batch_ms = median_ms(lambda: next(it))
    records = []
    handler = logging.Handler(logging.INFO)
    handler.emit = records.append
    logger = logging.getLogger("oktopk_tpu_torch")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    try:
        rc = main_trainer.main([
            "--dnn", AN4_DNN, "--dataset", "an4", "--data-dir", data_dir,
            "--device", str(dev), "--num-workers", "4", "--batch-size",
            "2", "--density", "0.02", "--grad-clip", "400", "--lr", "3e-4",
            "--max-iters", "4", "--warmup-steps", "1", "--ckpt-dir", d,
            "--ckpt-every", "4", "--seed", str(SEED), "--log-every", "1"])
    finally:
        logger.removeHandler(handler)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_counts()
    msgs = [r.getMessage() for r in records]
    saved = [m for m in msgs if m.startswith("checkpoint ")]
    if rc != 0 or not saved or any("synthetic" in m for m in msgs):
        raise AssertionError(f"an4_eval main_trainer: exit {rc}, {msgs}")
    assert_launched(launches, SPARSE_KERNELS, "an4_eval main_trainer")
    torch.cuda.empty_cache()
    res = {}
    for where in (str(dev), "cpu"):
        t0 = time.perf_counter()
        metrics, hyps = evaluate.evaluate(evaluate.parse_args([
            "--dnn", AN4_DNN, "--dataset", "an4", "--data-dir", data_dir,
            "--ckpt", d, "--batch-size", "2", "--num-batches", "2",
            "--device", where]))
        res[where] = (metrics, hyps, time.perf_counter() - t0)
        ckpt.clear_cache()
        torch.cuda.empty_cache()
    (gm, gh, gs), (cm, ch, cs) = res[str(dev)], res["cpu"]
    if not all(math.isfinite(v) for v in gm.values()):
        raise AssertionError(f"an4_eval: card metrics {gm}")
    rel = abs(gm["loss"] - cm["loss"]) / abs(cm["loss"])
    if rel > 1e-4:
        raise AssertionError(f"an4_eval: loss card {gm['loss']} vs CPU "
                             f"{cm['loss']} ({rel:.2e} relative)")
    differing = sum(a != b for a, b in zip(gh, ch))
    if not differing and (gm["wer"], gm["cer"]) != (cm["wer"], cm["cer"]):
        raise AssertionError("an4_eval: equal hypotheses, other WER/CER")
    out = {"phase": "an4_eval", "utterances": 16, "frames": 400,
           "batch_ms": batch_ms, "train_s": train_s, "checkpoint": saved[0],
           "launches": launches, "card": gm, "cpu": cm,
           "loss_rel_diff": rel, "hypotheses": len(gh),
           "differing_hypotheses": differing, "eval_card_s": gs,
           "eval_cpu_s": cs, "hypothesis_0": gh[0] if gh else None}
    emit(out)
    return out


def _ckpt_rank(rank: int, tmp: str, world: int, dev: str, ckpt_dir: str):
    import torch.distributed as dist

    from oktopk_tpu_torch.train import main_trainer
    from oktopk_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
    dist_join(rank, world, tmp, "gloo", dev)
    argv = ["--device", dev, "--backend", "gloo"]
    trainer, data, _, _ = main_trainer.build_trainer(vgg_args(argv))
    recs, launches = run_vgg_steps(trainer, data, 4)
    t0 = time.perf_counter()
    state = trainer.train_state()          # every row gathered to rank 0
    gather_s = time.perf_counter() - t0
    if rank == 0:
        save_checkpoint(ckpt_dir, state, 4)
    del state
    dist.barrier()
    # the ranks' agreement on a stop, polled before each step: one
    # stopping poll (no step runs)
    agree_ms = median_ms(lambda: trainer.train(data, 1,
                                               should_stop=lambda: True),
                         reps=20)
    fresh, _, _, _ = main_trainer.build_trainer(vgg_args(argv))
    tree, step = restore_checkpoint(ckpt_dir, fresh.train_state(
        gather=False))
    fresh.load_train_state(tree)
    n = trees_bit_equal(fresh.train_state(host=True, gather=False),
                        trainer.train_state(host=True, gather=False),
                        f"dist_ckpt rank {rank} restore")
    return {"step": step, "leaves": n, "launches": launches,
            "losses": [r["loss"] for r in recs], "gather_s": gather_s,
            "agree_ms": agree_ms}


def ckpt_rank(rank, tmp, world, dev, ckpt_dir):
    """Spawn target: full-width VGG-16 as one gloo rank, four steps, a
    checkpoint (the rows gathered to rank 0), its restore; host seconds
    of the gather and host ms of one stop poll (the ranks' agreement)."""
    dist_guard(_ckpt_rank, rank, tmp, world, dev, ckpt_dir)


def phase_dist_ckpt(dev, root: str) -> dict:
    """Four gloo ranks of full-width VGG-16 through ``main_trainer.
    build_trainer`` (one dense warmup step, three oktopk steps), then a
    checkpoint: its ``state`` tree bit-equal to the stacked Trainer's
    file from the same seed, and a four-rank restore that puts each
    rank's row back, bit for bit."""
    import torch
    from oktopk_tpu_torch.train import main_trainer
    from oktopk_tpu_torch.train.checkpoint import (clear_cache,
                                                   read_payload,
                                                   save_checkpoint)

    stacked_dir = os.path.join(root, "dist_stacked")
    ranks_dir = os.path.join(root, "dist_ranks")
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        trainer, data, _, _ = main_trainer.build_trainer(vgg_args(
            ["--device", str(dev), "--num-workers", str(DIST_P)]))
        want, _ = run_vgg_steps(trainer, data, 4)
        save_checkpoint(stacked_dir, trainer.train_state(), 4)
        del trainer
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn_ranks(ckpt_rank, DIST_P,
                            (DIST_P, str(dev), ranks_dir), "dist_ckpt")
        ranks_s = time.perf_counter() - t0
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev
    for r, res in enumerate(ranks):
        if res["losses"] != [w["loss"] for w in want]:
            raise AssertionError(f"dist_ckpt rank {r}: losses "
                                 f"{res['losses']} vs stacked")
        assert_launched(res["launches"], SPARSE_KERNELS,
                        f"dist_ckpt rank {r}")
    got = read_payload(os.path.join(ranks_dir, "ckpt-4.msgpack"),
                       use_cache=False)["state"]
    ref = read_payload(os.path.join(stacked_dir, "ckpt-4.msgpack"),
                       use_cache=False)["state"]
    leaves = trees_bit_equal(got, ref, "dist_ckpt file")
    clear_cache()
    out = {"phase": "dist_ckpt", "model": "vgg16", "ranks": DIST_P,
           "file_equal_to_stacked": True, "leaves": leaves,
           "residual_rows": int(got["sparse_state"]["residual"].shape[0]),
           "bytes": os.path.getsize(os.path.join(ranks_dir,
                                                 "ckpt-4.msgpack")),
           "restored_rows_bit_equal": [res["leaves"] for res in ranks],
           "gather_s": [res["gather_s"] for res in ranks],
           "stop_poll_ms": [res["agree_ms"] for res in ranks],
           "ranks_s": ranks_s}
    emit(out)
    return ranks[0]["launches"]


def slice9_phases(dev, by_path: dict) -> None:
    """The train-surface phases in one temporary directory (the state
    directory inside it), removed at the end; each phase's time."""
    import shutil
    import tempfile

    import torch
    root = tempfile.mkdtemp(prefix="oktopk_slice9_")
    secs = {}
    old = {k: os.environ.get(k) for k in ("OKTOPK_STATE_DIR",
                                         "OKTOPK_NATIVE")}
    os.environ["OKTOPK_STATE_DIR"] = os.path.join(root, "state")
    os.environ["OKTOPK_NATIVE"] = "1"       # g++ failing must fail the run
    try:
        for name, fn in (("text_data", lambda: phase_text_data(root)),
                         ("bert_ckpt", lambda: phase_bert_ckpt(dev, root)),
                         ("preempt", lambda: phase_preempt(root)),
                         ("glue_cli", lambda: phase_glue_cli(dev, root)),
                         ("an4_eval", lambda: phase_an4_eval(dev, root)),
                         ("dist_ckpt", lambda: phase_dist_ckpt(dev, root))):
            t0 = time.perf_counter()
            res = fn()
            secs[name] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            if name == "bert_ckpt":
                by_path["bert, resumed from its checkpoint"] = \
                    res["launches"]
            elif name == "glue_cli":
                by_path[f"glue ({BERT9_MODEL}, MRPC)"] = res["launches"]
            elif name == "an4_eval":
                by_path["lstman4 on AN4 files (main_trainer CLI)"] = \
                    res["launches"]
            elif name == "dist_ckpt":
                by_path["oktopk + checkpoint, one worker per process "
                        "(rank 0 of 4)"] = res
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "slice9_seconds", **secs, "total": sum(secs.values())})


def kernel_line(timings, errs, by_path, edge_err, big, tf_timings):
    """The ``{"kernels": [...]}`` entries at the main path's shapes (the
    compaction's phase-(a) form; ``forms`` has every form), then each
    larger model's forms at its n (``big``: {path: (n, timings, errs)}):
    BERT-base's at n = 110,106,428 (``bert_sweep``, ``bert_pack_a``,
    ``bert_select_b``) and DeepSpeech's at n = 54,791,168
    (``lstman4_sweep``, ...), VGG-16's two buckets' (``vgg16_b0_sweep``,
    ...), the pipeline's stage and shared buckets of BERT-base
    (``bert_pp_stage_sweep``, ``bert_pp_shared_sweep``, ...), the seq
    path's bucket (``bert_seq_pack_a``, ``bert_seq_2048_sweep``, ...),
    the tp path's (``bert_tp_shard_sweep``, ``bert_tp_shared_sweep``,
    ...) and the expert path's (``bert_moe_shard_sweep``,
    ``bert_moe_shared_sweep``, ...). ``ms``,
    ``plain_ms`` and ``library_ms`` are call
    times, CUDA events around one call; the ``*device_ms`` keys are the
    device times of the same calls under the profiler. ``launches`` counts
    the main path's run (oktopk on VGG-16; a larger model's forms: that
    model's run; the two-level forms ``hier_pack_a``, ``hier_select_b``:
    the ``hierarchical`` phase's); ``launches_by_path`` every path's
    (``by_path``: {path: {kernel: launches}}; ``big``: {form prefix:
    (path, n, timings, errs)})."""
    def times(f):
        lib = f.get("library")
        return {"ms": f["kernel"]["call_ms"],
                "device_ms": f["kernel"]["device_ms"],
                "launches_per_call": f["kernel"]["launches_per_call"],
                "plain_ms": f["plain"]["call_ms"],
                "plain_device_ms": f["plain"]["device_ms"],
                "bound_ms": f["bound_ms"],
                "library_ms": lib["call_ms"] if lib else None,
                "library_device_ms": lib["device_ms"] if lib else None,
                "device_ops": f["kernel"]["device_ops"]}

    comp_err = max(errs["compaction"], edge_err)
    forms = {nm: {"R": timings[nm]["R"], "cap": timings[nm]["cap"],
                  **times(timings[nm])}
             for nm in ("pack_a", "select_b", "select_local",
                        "select_nonzero", "pack_static", "pack_proto")}
    def launches(kernel, path="oktopk"):
        return {"launches": by_path[path][kernel],
                "launches_by_path": {p: d.get(kernel, 0)
                                     for p, d in by_path.items()}}

    threefry = [
        {"name": form, "route": "cuda",
         "source": "oktopk_tpu_torch/csrc/threefry.cu",
         "replaces": "oktopk_tpu/models/bert.py:69",
         "replaces_note": "no Pallas kernel: XLA's threefry behind flax "
                          "nn.Dropout (jax.random.bernoulli)",
         **launches("threefry", "bert"), "max_abs_err": 0.0,
         "bit_equal": True, "bound_by": "operations",
         "shape": tf_timings[form]["shape"],
         "ms": tf_timings[form]["kernel"]["call_ms"],
         "device_ms": tf_timings[form]["kernel"]["device_ms"],
         "launches_per_call":
             tf_timings[form]["kernel"]["launches_per_call"],
         "plain_ms": tf_timings[form]["plain"]["call_ms"],
         "plain_device_ms": tf_timings[form]["plain"]["device_ms"],
         "bound_ms": tf_timings[form]["bound_ms"],
         "library_ms": None, "library_device_ms": None,
         "device_ops": tf_timings[form]["kernel"]["device_ops"]}
        for form in THREEFRY_FORMS]

    return [
        {"name": "fused_select", "route": "cuda",
         "source": "oktopk_tpu_torch/csrc/fused_select.cu",
         "replaces": "oktopk_tpu/ops/fused_select.py:64",
         **launches("fused_select"),
         "max_abs_err": errs["fused_select"],
         "bit_equal": errs["fused_select"] == 0.0,
         "bound_by": "bytes", **times(timings["fused_select"])},
        {"name": "compaction", "route": "cuda",
         "source": "oktopk_tpu_torch/csrc/compaction.cu",
         "replaces": "oktopk_tpu/ops/compaction.py:160",
         "also_replaces": ["oktopk_tpu/ops/compaction.py:229",
                           "scripts/proto_repair_kernel.py:78"],
         **launches("compaction"),
         "max_abs_err": comp_err, "bit_equal": comp_err == 0.0,
         "bound_by": "bytes", **forms["pack_a"], "forms": forms},
    ] + [
        {"name": form, "route": "cuda",
         "source": f"oktopk_tpu_torch/csrc/{kernel}.cu", "replaces": tpu,
         "launches": by_path[path][kernel],
         "max_abs_err": errs_n[form],
         "bit_equal": errs_n[form] == 0.0, "bound_by": "bytes", "n": n,
         **{k: timings_n[form][k] for k in ("R", "cap")
            if k in timings_n[form]},
         **times(timings_n[form])}
        for prefix, (path, n, timings_n, errs_n) in big.items()
        for form, kernel, tpu in (
            (f"{prefix}_sweep", "fused_select",
             "oktopk_tpu/ops/fused_select.py:64"),
            (f"{prefix}_pack_a", "compaction",
             "oktopk_tpu/ops/compaction.py:160"),
            (f"{prefix}_select_b", "compaction",
             "oktopk_tpu/ops/compaction.py:160"))
        if form in timings_n] + threefry


def main() -> int:
    # cuBLAS repeats its sums only with this set before the CUDA context
    # exists (the reproducibility checks)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import oktopk_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    phase_build()
    timings, errs = phase_kernels(dev)
    edge_err, timings["pack_proto"] = phase_edges(dev)
    tf_timings = phase_threefry(dev)
    phase_combine(dev)
    big = {"bert": ("bert", N_BERT) + phase_big_kernels(
        dev, "bert_kernels", "bert", N_BERT, 0.01, 2.576, SEED + 4)}
    big["lstman4"] = ("lstman4", N_LSTMAN4) + phase_big_kernels(
        dev, "lstm_kernels", "lstman4", N_LSTMAN4, 0.02, 2.326, SEED + 5)
    # the outer oktopk's forms at P = num_pods = 2 (K1 as at VGG-16's n)
    big["hier"] = ("hierarchical", N_VGG16) + phase_big_kernels(
        dev, "hier_kernels", "hier", N_VGG16, 0.02, 2.326, SEED + 6, P=2,
        sweep=False)
    big["resnet50"] = ("resnet50", N_RESNET50) + phase_big_kernels(
        dev, "resnet50_kernels", "resnet50", N_RESNET50, 0.02, 2.326,
        SEED + 7)
    # the resilience path's two buckets of VGG-16 (``--num-buckets 2``)
    for b, n_b in enumerate(vgg16_bucket_sizes()):
        big[f"vgg16_b{b}"] = ("vgg16 resilience", n_b) + phase_big_kernels(
            dev, "vgg16_bucket_kernels", f"vgg16_b{b}", n_b, 0.02, 2.326,
            SEED + 8 + b)
    # the pipeline's buckets at BERT-base, pp = 2: a stage's and the
    # shared one, each over its data group of dp = 2
    for prefix, n_b, sd in (("bert_pp_stage", N_PP_STAGE, SEED + 10),
                            ("bert_pp_shared", N_PP_SHARED, SEED + 11)):
        big[prefix] = ("bert pipeline", n_b) + phase_big_kernels(
            dev, "pipeline_kernels", prefix, n_b, 0.01, 2.576, sd, P=2)
    # the seq path's one bucket over a data group of dp = 2: at T <= 512
    # (K1's shape is bert_sweep's) and with 2,048 position rows; the tp
    # path's shard and shared buckets at tp = 2, dp = 2
    for prefix, path, n_b, sd, sweep in (
            ("bert_seq", "bert seq", N_BERT, SEED + 12, False),
            ("bert_seq_2048", "bert seq", N_BERT_2048, SEED + 13, True),
            ("bert_tp_shard", "bert tp", N_TP_SHARD, SEED + 14, True),
            ("bert_tp_shared", "bert tp", N_TP_SHARED, SEED + 15, True)):
        big[prefix] = (path, n_b) + phase_big_kernels(
            dev, "seq_tp_kernels", prefix, n_b, 0.01, 2.576, sd, P=2,
            sweep=sweep)
    # the expert path's buckets at ep = 2 (4 experts), dp = 2: a worker's
    # expert shard and its shared copy
    for prefix, n_b, sd in (("bert_moe_shard", N_MOE_SHARD, SEED + 16),
                            ("bert_moe_shared", N_MOE_SHARED, SEED + 17)):
        big[prefix] = ("bert moe", n_b) + phase_big_kernels(
            dev, "moe_kernels", prefix, n_b, 0.01, 2.576, sd, P=2)
    phase_allreduce(dev)
    phase_baselines_allreduce(dev)
    phase_hier_allreduce(dev)
    phase_bert_parity(dev)
    by_path = {"oktopk": phase_trainer(dev), **phase_baselines_trainer(dev),
               "oktopk step options": phase_step_options(dev)}
    torch.cuda.empty_cache()
    by_path["vgg16 obs"] = phase_obs_trainer(dev)
    torch.cuda.empty_cache()
    by_path["vgg16 resilience"] = phase_resilience(dev)
    torch.cuda.empty_cache()
    by_path["vgg16 autotune"] = phase_autotune(dev)
    torch.cuda.empty_cache()
    by_path["vgg16 anatomy"] = phase_anatomy(dev)
    torch.cuda.empty_cache()
    by_path["mnistnet convergence"] = phase_convergence(dev)
    torch.cuda.empty_cache()
    by_path["bert"] = phase_bert_trainer(dev)
    torch.cuda.empty_cache()
    by_path["bert pipeline"] = phase_pipeline(dev)
    torch.cuda.empty_cache()
    by_path["bert seq"] = phase_seq_parallel(dev)
    torch.cuda.empty_cache()
    by_path["bert tp"] = phase_tensor_parallel(dev)
    torch.cuda.empty_cache()
    by_path["bert moe"] = phase_expert_parallel(dev)
    torch.cuda.empty_cache()
    phase_lstman4_parity(dev)
    phase_zoo_parity(dev)
    by_path["lstman4"] = phase_lstman4_trainer(dev)
    by_path["lstm (PTB)"] = phase_lstm_trainer(dev)
    by_path["resnet50"] = phase_resnet50_trainer(dev)
    t0 = time.perf_counter()
    phase_bf16_parity(dev)
    by_path.update(phase_bf16_trainer(dev))
    phase_bf16_cli(dev)
    emit({"phase": "bf16_seconds", "total": time.perf_counter() - t0})
    phase_loader_cli(dev)
    slice9_phases(dev, by_path)
    by_path["hierarchical"] = phase_hierarchical(dev)
    phase_dist_allreduce(dev)
    by_path["hierarchical, one worker per process (rank 0 of 4)"] = \
        phase_dist_hierarchical(dev)
    by_path["oktopk, one worker per process (rank 0 of 4)"] = \
        phase_dist_trainer(dev)
    by_path["bert, one worker per process (rank 0 of 4)"] = \
        phase_dist_bert(dev)
    by_path["bert pipeline, one worker per process (rank 0 of 4)"] = \
        phase_dist_pipeline(dev)
    kernels = kernel_line(timings, errs, by_path, edge_err, big,
                          tf_timings)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "nvidia-smi unavailable"
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
