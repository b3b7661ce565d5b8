#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fgvc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--phases card,build,kernel,e2e,plain,raft,decode,vos,vos_plain,
                                    codecs,modes,zoo,kinetics,jhmdb,badja,sp,passes,overlap,
                                    profile,serve,export,doctor,train,realtrain,propmodes,dp,
                                    bank,mp,ddp,reproduce,demo,video,dataprep]

Phases, each of which raises on failure (exit code != 0):
  card      the card's name and power limit (nvidia-smi);
  build     every CUDA source of fgvc_tpu_torch/csrc, one nvcc each, in
            parallel;
  kernel    each kernel against its plain PyTorch version on the card, in
            each compute mode ('float32': K1 and K2; 'high' and 'bfloat16':
            K3), for distinct key frames and for the first step's tie case
            (frame 0 in two valid slots): the banked entry with the circle
            window at TAP-Vid shapes (128 x 128 x 256 features, 6 key slots,
            radius 15, top-10, 32 values), and the banked entry with the
            square window and the unbanked entry at DAVIS VOS shapes (240 x
            440 x 256, 5 values).  The kernel multiplies on the tensor cores
            in an order the plain version cannot repeat, so each query
            pixel's output is held to its mode's limit (1e-4 in 'float32'
            and 'high'; 2^-7 max|v| in 'bfloat16', where a weight w one ulp
            apart can round to the neighbouring bf16 value), except near-tie
            rows: those whose plain k-th and (k+1)-th largest live
            affinities lie within 1e-4 of each other, where rounding can
            change a top-k member.  Rows beyond the limit must all be
            near-tie rows and at most 0.1% of the rows; their count is
            printed.  The tie case is exact: cut 'ab' (K5) of the unbanked
            entry on it gives even counts above and at the threshold on
            every row (each key ties with its copy).  The tie-heavy case
            (integer features on a few channels, no normalisation,
            temperature 1, a flat quarter in every frame) is exact in every
            mode at both shapes: every mode computes those affinities
            exactly, so cut 'ab''s thresh, mmax, frac, n_above and cnt_at
            equal the plain version's and z and the whole kernel's output
            agree within 1e-6 relative.  Then K4, the row
            blocks of spatial-parallel propagation, in each mode: TAP-Vid
            shapes (circle) in S = 2 and 3 blocks, VOS shapes (square) in
            S = 2 and 4, distinct frames (and the tie case at S = 2); each
            block against its plain version by the same rule, and the
            blocks, gathered and cut to the feature height, against the
            unsharded K1/K3 output with max |diff| = 0 (bit for bit); in
            'float32' each S's frame (its S blocks) timed against the
            unsharded call, and S = 2 per block launch, bounded by the
            block's own live pairs.  Each record of K1-K5 also carries
            affinity_kernel's and select_kernel's own device ms per launch
            (torch.profiler) and select_kernel's bound (its bytes: the
            scratch read once, the values, the output).  Last, K1 with the
            square window in 'float32' at the keypoint tasks' shapes, JHMDB
            (160 x 160, 15 values) and BADJA (160 x 256, 20 values), by the
            same rule, timed and bounded; and K1 at the zoo's shapes (C = 384
            at 32 x 32, dino_vit_s8; C = 768 at 32 x 32, dino_vit_b8; C = 144
            at 8 x 8, one partial tile, hrnet_w18; square at 60 x 110 x 768 Cv
            5, dino_vit_b8 on VOS; square at 20 x 20 x 384 Cv 15,
            dino_vit_s16 on JHMDB) in 'float32', timed and bounded, and in
            'high' and 'bfloat16' by the same rule;
  e2e       run_task('davis') (the CLI's path) on two synthetic TAP-Vid
            pickles (48 frames, 256 x 256, 32 tracks) with seeded random
            weights at the full width of ResNet-18-d1; K1's launches must
            equal the frames propagated, K2's must be 0;
  plain     one of those videos again with the propagation forced through
            the plain version on the card: median trajectory |diff| <= 1e-3
            px and <D within 0.1;
  raft      the RAFT baseline (--model raft) with seeded weights at the
            official width (fnet and cnet 256 channels, batch-normed cnet,
            12 iterations, 4 levels, radius 4) loaded through load_raft_pth
            from a .pth under the official names: (a) one 256 x 256 pair of
            e2e video 0 at batch 1 on the card against the same model on the
            CPU, final flow median |diff| <= 1e-3 px and max <= 1e-2 px, its
            ms by CUDA events; (b) run_task('davis', model='raft') on the e2e
            pickles, no attention kernel launched, metrics finite; video 0's
            flows (ms a flow by CUDA events), chain_flows_track ms, wall time,
            peak memory, busy share and top kernels (torch.profiler); (c)
            video 0's trajectories on the card against the port on the CPU:
            median |diff| <= 1e-2 px and <D within 0.1;
  decode    run_task('davis') on the e2e pickles with visibility_mode
            'heatmap', once with decode_impl 'upsample' and once 'coarse':
            K1 launches one per frame propagated, metrics finite, the share
            of visible predictions, AJ and OA, video 0's wall time under
            each; 'upsample' trajectories equal to the default tracker's
            (e2e's) bit for bit; video 0 with the propagation through the
            plain version ('upsample'): visibilities agree on >= 99.9% of
            (frame, point) pairs, median trajectory |diff| <= 1e-3 px, <D
            within 0.1; video 0 with the card listed twice (K4, two blocks a
            frame) under each decode: trajectories and visibilities equal to
            the unsharded run's bit for bit;
  vos       eval_vos (the path of `--task vos`) on two synthetic DAVIS-like
            videos (24 frames, 480 x 854 resized to 480 x 880 as the reader
            does, three moving objects) with seeded random weights, once
            banked and once with save_mem: K1 (square) launches must equal the
            frames propagated on the banked run and K2's on the save_mem run,
            the other kernel 0; J&F finite, and mean_iou (core/metrics/iou)
            over video 0's label maps printed beside it; the two runs' label
            maps agree on >= 99.99% of pixels;
  vos_plain one of those videos cut to 8 frames, banked and save_mem, again
            with the propagation forced through the plain versions on the
            card: label maps agree with the kernels' on >= 99.999% of pixels
            and J&F-Mean within 1e-4;
  codecs    the host codec library (fgvc_tpu_torch/csrc/fgpack.cpp, g++, no
            nvcc): (a) built, with g++'s version and the build seconds; (b)
            seeded 256 x 256 and 480 x 854 frames (integer arithmetic only,
            the same bytes on every machine) encoded at quality 95 and
            decoded: the sha256 of the bytes and of the pixels must equal
            the constants CODEC_PINS, which tests/test_torch_port_codecs.py
            holds to cv2's encode and PIL's decode (libjpeg); (c) host ms a
            480 x 854 frame for JPEG decode on one thread and on
            os.cpu_count() threads, encode, palette and RGB PNG decode and
            I420, and FgPack.read_batch's MB/s over a 250-frame 256 x 256
            JPEG pack in both layouts; (d) a DAVIS tree written by the port's
            encoders (24 JPEG frames at 480 x 854, palette PNG annotations):
            run_task('vos') through K1 square, its J&F equal to eval_vos's on
            the tree's files and on the decoded arrays in memory, label maps
            equal; a TAP-Vid pickle of JPEG bytes (the e2e videos encoded):
            run_task('davis') through K1 circle, metrics equal to a uint8
            pickle of the same decoded frames; (e) upload_format 'yuv420'
            on the e2e pickles: K1 launches as many as 'rgb' (one per frame
            propagated), <D and the bytes uploaded beside 'rgb''s; then an
            8-frame 128 x 128 cut, card against CPU: median |diff| <= 1e-3
            px; (f) the committed files of tests/torch_port_fixtures made by
            PIL and cv2 (progressive JPEG at 480 x 854 and at 256 x 256 with
            restart markers, 4:4:0 and 4:1:1 JPEG, an Adam7 RGB PNG at 540 x
            960, WebP: cv2's lossy q90 at 540 x 960 and lossless at 216 x
            384, PIL's lossy with alpha at 120 x 160) read by read_image,
            each WebP's decode ms printed: the sha256 of the pixels must equal
            FIXTURE_PINS, PIL's and cv2's decode of the same bytes; the
            port's encode_jpeg bytes with an APP1 Exif segment spliced in,
            orientations 1-8 in both byte orders: read_image's shape and
            pixels equal to the transform of the unrotated decode and to
            EXIF_PINS (cv2.imread's), flags 'unchanged' and decode_jpeg
            unrotated; host ms a 480 x 854 frame of the progressive decode
            beside the baseline decode of the same pixels, on one thread and
            os.cpu_count(); (g) the committed CMYK fixture
            (tests/torch_port_jpeg_forms: PIL's Adobe CMYK at 480 x 854)
            through decode_jpeg (PIL's four channels) and read_image (cv2's
            conversion), and the progressive fixture cut after 1 and 5 of its
            10 scans (libjpeg's interblock smoothing): the sha256 of the
            pixels equal to JPEG_FORM_PINS (PIL's and cv2's decode), host ms
            a frame of each beside the baseline decode;
  modes     K3 end to end: run_task('davis') on the e2e pickles with
            matmul_precision 'highest', 'high' and 'default', and eval_vos on
            one synthetic VOS video, banked and save_mem, in the same three;
            each run's launches must all be of its mode's kernel (one per
            frame propagated) and of its entry.  Against 'highest' on the same
            data: 'high' median trajectory |diff| <= 1e-2 px and <D within
            0.1; 'default' <D within 0.5 (the repo's fidelity bar,
            docs/precision_study.md); VOS J&F-Mean within 0.005.  Then that
            video cut to 8 frames in 'high' and 'default', through the
            kernels and the plain versions: label maps agree on >= 99.99%;
  zoo       run_task('davis', backbone=NAME) for the eight zoo entries
            beside ResNet-18-d1 (DINO S/8, S/16, B/8, ViT-S/d8, Swin-T,
            HRNet-W18, MAST, positional ResNet-18) at their published widths
            with seeded weights, on e2e video 0: K1 launches one per frame
            propagated; per entry the grid, C, backbone ms a frame, ms a
            video, peak memory, and the video through K1 and the plain
            version (median |diff| <= 1e-3 px, <D within 0.1); then
            dino_vit_b8 on one 24-frame VOS video banked (K1 square at 60 x
            110 x 768; each frame's rows beyond 1e-4 of the plain version
            on the same inputs all near-tie rows, label maps >= 99.99% equal
            to the plain version's end to end); then swin_tiny on JHMDB's
            320 x 320 must raise the JAX failure's ValueError; then
            run_task('jhmdb', backbone='dino_vit_s16') on the jhmdb phase's
            tree at the dataset's size (K1 square at 20 x 20 x 384, Cv 15):
            launches one per frame propagated, PCK finite, video 0 through
            K1 and the plain version (median |diff| <= 1e-3 px);
  kinetics  run_task('kinetics', query_mode='strided') on one synthetic
            TAP-Vid-Kinetics shard (250 frames stored at 360 x 640, resized
            to 256 x 256 by the reader; 32 tracks visible throughout, so
            every 5th frame queries all of them): K1 (circle) launches one
            per frame of each query group (6,325), metrics finite; wall
            time, frames/s, peak device memory; then the last three query
            groups through K1 and its plain version on the same features:
            median |diff| <= 1e-3 px, and K1's device ms per launch;
  jhmdb     run_task('jhmdb') on a JHMDB tree (val_list.txt, PNG frames
            written with zlib, a .mat of pos_img per video through
            scipy.io) of two 40-frame 240 x 320 videos with 15 joints, read
            from the files by the port's PNG decoder.  K1 (square, 160 x
            160, 15 values) launches one per frame
            propagated; PCK@0.1-0.5 finite; then video 0 through K1 and
            through the plain version: median |diff| <= 1e-3 px, both PCKs
            printed, K1's device ms per launch;
  badja     the same for run_task('badja') on one 60-frame video with
            JPEG frames at 1080 x 1920 (written by the port's encoder,
            resized to 320 x 512 by the reader), 20 joints annotated on every
            5th frame and palette PNG segmentations expanded to BGR as cv2
            reads them (K1 square, 160 x 256, 20 values);
  sp        spatial-parallel propagation (--spatial-devices) on this card
            listed S times: run_task('davis') on the e2e pickles at S = 2,
            whose trajectories equal the unsharded tracker's (<= 1e-6 px) and
            whose <D equals the unsharded run's; one synthetic VOS video (24
            frames) banked at S = 2 and save_mem at S = 4 in 'highest', and
            save_mem at S = 2 in 'default', label maps 100% equal to the
            unsharded runs of the same mode.  Each run launches only K4, S per
            frame propagated; peak device memory beside the unsharded run's.
            With two cards or more, the TAP-Vid case again on two distinct
            cards (frame-parallel features at half the batch: trajectories
            within the plain phase's 1e-3 px median).  Last, JHMDB video 0
            through track_heatmaps with the card listed twice (K4 square,
            two blocks a frame): coordinates equal to the unsharded run's.
  passes    K5, the kernel's profiling cut-downs, through the profiling tool
            (python -m fgvc_tpu_torch.bench.pass_breakdown) at its shapes
            (TAP-Vid: 128 x 128 x 256, 6 slots, radius 15, top-10, 32
            values, circle) in each compute mode: the cut launches counted
            (one per call of each cut), the per-pass split printed; then each
            cut against its plain version on the card: cut 'a' masked
            affinities equal bit for bit and the live ones within 2e-5
            max|a|, once at the tool's 32 columns and once at Cv = 2304,
            every column of slot 0's window (live ones included); cut 'ab'
            n_above and cnt_at equal, thresh, mmax and frac within 1e-4, z
            within 1e-5 relative, on every row but near-tie rows (as in
            `kernel`, and rows whose (k-1)-th and k-th largest live
            affinities lie within 1e-4: the counts at and above the
            threshold move there);
  overlap   K6, the tensor-core / SIMT overlap microbenchmark, through its
            tool (python -m fgvc_tpu_torch.bench.mxu_vpu_overlap): the three
            kinds' times, the overlap quality and torch.matmul's time; then
            each kind against its plain version: 'mxu' max |diff| <= 1e-3,
            'mixed' - 'mxu' the plain version's integer counts, 'vpu' 10 * FK
            on every row;
  profile   python -m fgvc_tpu_torch.cli.test --task davis --profile DIR on
            one e2e pickle: the Chrome trace holds the propagate[0] and
            collect[0] spans and both CUDA kernels of K1;
  serve     python -m fgvc_tpu_torch.cli.serve's server (serve_tracker: the
            davis preset at 256 x 256, heatmap visibility, seeded
            ResNet-18-d1 at full width, warmed) on an ephemeral port, over
            HTTP: (a) /v1/track with e2e video 0 (48 frames, 32 points
            queried at frames 0, 10, 20): 111 K1 launches, the reply equal
            to track_points bit for bit; (b) the same video at 480 x 854:
            equal to track_points on the host-resized frames with the
            points scaled, the query-frame rows on the client's points; (c)
            (a) and (b) at once from two threads, each equal to its serial
            answer; (d) /v1/vos with a 24-frame 480 x 854 video and a
            3-object mask: 23 K1 square launches at 128 x 128, masks equal
            to track_masks label for label, the reply's encode timed apart;
            (e) /healthz, /stats, a 400, a 413 and a 404.  Each request's
            server ms, frames/s and peak device memory; then K1 square at
            128 x 128, Cv 4 against its plain version, timed and bounded;
  export    the serving step exported on the card (256 x 256 frame, 6 key
            slots, Cv 8), saved and loaded: one K2 launch (circle window)
            through the operator fgvc_tpu_torch::topk_attention, the loaded
            program equal to the step bit for bit and to the plain version
            by the kernel rule; the operator timed and bounded, the step's
            ms by CUDA events, the artifact's MB; then cli.export --check
            and --format torch;
  doctor    python -m fgvc_tpu_torch.cli.doctor --json: exit 0, this card's
            name, nvcc, K1 against its plain version;
  train     the mixed training recipe (fgvc_tpu_torch.apis.train.train_model
            on structured synthetic data): (a) the TrainConfig defaults at
            full width (crop 256, batch 4, radius 24, 'high', all three
            branches, ResNet-18-d1) for 8 steps with finite losses, the
            median step ms from step 3 on, the peak device memory, and 3
            steps under torch.profiler (busy share, top kernels); (b) one
            step at crop 64, radius 4, 'highest' on the card and on the CPU
            from the same weights, batch and dropped channels: losses within
            1e-4 relative, every gradient leaf within 1e-3 relative L2;
            (c) 2 steps + resume + 2 against 4 steps on the card: parameters
            and statistics within 1e-4; (d) mid-training validation
            (make_synthetic_val_fn) on the student: K1 launched, metrics
            finite; (e) compute_dtype 'bfloat16' at full width: losses at
            init within 1% of float32's (same weights, batch, channels), 8
            steps with parameters, statistics and Adam's moments float32,
            the median step ms, peak memory and 3 profiled steps' busy
            share beside (a)'s;
  realtrain real-data training: a YouTube-VOS tree (8 videos x 6 JPEG frames
            at 256 x 455, the port's encoder at quality 95, and a --ytv-list
            JSON of every other frame) and a FlyingThings3D tree (2 scenes x
            5 RGB PNG frames at 540 x 960 with their into-future and
            into-past 'PF' flows) written here from integer-made frames:
            (a) FlyingThingsYtvDataset's host ms a sample (the median of 20)
            split into YouTube-VOS decode, PNG decode, PFM read, crop and
            resize, blur and Lab, and ms a batch of 4; (b) python -m
            fgvc_tpu_torch.cli.train --ytv-root --flyingthings-root
            --ytv-list with the TrainConfig defaults for 8 steps and
            --synthetic-val: finite losses, the median step ms from step 3
            on beside phase train's synthetic step, the peak device memory,
            K1's launches in the validation; then 3 steps with the reader in
            the loop under torch.profiler (busy share); (c) at crop 64, 2
            steps + resume + 2 against 4 steps on the card: parameters and
            statistics within 1e-4, the resumed run's batches equal; (d)
            the FlyingThings3D tree again with WebP cleanpass frames (each
            the committed 540 x 960 lossy fixture; the card's machine has no
            WebP encoder): (a)'s split with WebP decode in PNG's place, and
            cli.train on it for 4 steps at full width;
  propmodes the propagation modes beside the kernel (plain PyTorch: no
            attention kernel launches in them), seeded ResNet-18-d1 at full
            width, DAVIS_TEST_CFG, a 24-frame video made as the e2e pickles
            are (256 x 256, 32 tracks, queries at frames 0, 10, 20) through
            run_task('davis'):
            first one frame of 'tiled' against K1 on the same features (each
            query pixel within 1e-4 but K1's near-tie rows, at most 0.1%);
            (a) 'tiled' in each topk_impl against 'pallas' (K1), (b) 'dense'
            against 'tiled' 'exact': median trajectory |diff| <= 1e-3 px and
            <D within 0.1.  Where distinct keys tie exactly at the k-th
            value (the pan moves the texture by whole pixels, so features
            recur across key frames), 'exact' takes lax.top_k's members and
            K1, 'segmented' and 'certified' split the tie: 'exact' against
            K1 is held to the median, its <D gap printed; 'approx', which
            weighs every tied affinity in full, is reported, not held; (c) with_first_neighbor=False ('dense' with frame
            0 unmasked), 'c2f', 'flow_guided' and track_points_forward at
            full width, then each on an 8-frame 128 x 128 cut of the video
            on the card against the CPU (median |diff| <= 1e-3 px); (d) one
            synthetic VOS video (24 frames at 480 x 880) with 'tiled',
            banked and save_mem, against K1 and K2: label maps agree on
            >= 99.999% of pixels, J&F-Mean within 1e-4; (e) 'tiled' with the
            card listed twice (two row blocks a frame) against the
            unsharded run: max |diff| <= 1e-6 px.  Each run prints ms per
            video (CUDA events from dispatch to collect), frames/s, ms per
            propagated frame and peak device memory beside the card's name
            and power limit;
  dp        the single-process round-robin (--local-devices) with this card
            listed twice: run_task('davis') on the e2e pickles with
            local_devices=[card] * 2 launches K1 as many times as the
            single-device run (one per frame propagated) and gives its <D
            exactly; [[card] * 2] * 2 (two groups of two row blocks, dp x sp)
            launches only K4, two per frame propagated, with the same <D;
            two synthetic VOS videos through eval_vos on [card] * 2 give the
            single-device label maps on 100% of pixels.  Wall times beside the
            single device's (printed, not held).  With two cards or more (four
            for dp x sp), the same on distinct cards;
  bank      bank-parallel propagation (--bank-devices, attention_impl
            'tiled'): K1's trajectories of e2e video 0 first, then with K1's
            counters at 0 to the end of the phase: video 0 with the card
            listed 2 and 3 times (uneven shards) against the unsharded 'tiled'
            run with topk_impl 'certified' (the same tie split) and against
            K1: median |diff| <= 1e-3 px each (max printed), <D within 0.1 of
            K1's; one synthetic VOS video banked on [card] * 2 against the
            unsharded 'tiled' run: >= 99.999% of pixels agree; one 250-frame
            256 x 256 video, one query group, on [card] * 2: each shard's
            bytes against the whole bank's, peak device memory, wall time;
  mp        python -m fgvc_tpu_torch.cli.test --task davis on the e2e
            pickles as one process, then as two ranks started by python -m
            fgvc_tpu_torch.cli.launch --nprocs 2 (gloo on localhost, both
            ranks on this card): both ranks print metrics equal to the single
            process's, rank 1 writes no output directory, the ranks' K1
            launches add up to the single process's; both wall times.
  ddp       python -m fgvc_tpu_torch.cli.launch --nprocs 2 running python -m
            fgvc_tpu_torch.cli.train --synthetic at full width (global batch
            4, two per rank) over gloo on this card, 5 steps and validation
            at the end: step 1's losses within 1e-4 of one process's (the
            later steps' differences printed), K1 launched by rank 0's
            validation alone; a SIGTERM to a second launcher after step 1
            while an uninterrupted twin runs beside it: both ranks stop at
            one step, the restart resumes there, the log reads 1..5, the
            losses within 1e-4 of the twin's; step ms of two ranks and of
            one process;
  reproduce python -m fgvc_tpu_torch.cli.reproduce's main with seeded
            ResNet-18-d1 weights (random BatchNorm statistics) exported under
            the reference's mmcv names, over the e2e pickles as TAP-Vid-DAVIS
            and as Kinetics, the JHMDB and BADJA trees, --max-videos 1
            --fast-modes: the feature-parity probe on the card below 1e-3
            (and its seconds), exit 1 (seeded weights miss the published
            numbers), K1 launched one per frame propagated (circle for the
            TAP-Vid tasks and the three fast modes, two of them in
            'bfloat16', square at JHMDB's and BADJA's shapes), report.json's
            value of each task equal within 1e-6 to run_task's on the same
            inputs (each task's wall printed); the .pth with a negative
            BatchNorm variance exits 2 before any task;
  demo      python -m fgvc_tpu_torch.cli.demo's main on a directory of 24
            JPEG and PNG frames at 480 x 854 (the port's encoders): --grid 8
            at --size 256 launches K1 (circle, 128 x 128 x 256) once per
            frame propagated; the .mp4 holds one Motion-JPEG sample per
            frame, byte-equal to encode_jpeg (4:4:4) of the frames rendered
            again from the same tracks; its ms a frame split into reading,
            tracking, drawing and encoding, and its MB; --correspondence
            writes a .png that decodes to the overlay; --mask with a grey
            label PNG launches K1 square once per frame propagated and writes
            an .mp4, which the port's VideoReader reads back ('mp4v (JPEG)',
            24 frames of 256 x 256, within a mean level of libjpeg's decode
            of the same samples) and --video tracks (K1 circle 23 times);
            GIF: gif_fixture_frames() written by save_video byte for byte
            the committed tests/torch_port_fixtures/gif_256x256_24f.gif
            (PIL's writer through the JAX save_video; ms a frame to quantise
            and to LZW-encode, the MB), that file decoded to cv2's pins (the
            sha256 of its 23 frames, count, fps; ms a frame to decode), the
            demo's own --out tracks.gif (K1 circle 23 times) read back, each
            frame equal to its own palette's colours, and --video on it (K1
            circle once a frame read back less one);
  video     video files as input, no cv2 on this machine: (a) the committed
            VP8 WebM (tests/torch_port_fixtures/vp8_640x360_250f.webm, 250
            frames at 640 x 360, 25 fps, libvpx through cv2) decoded on the
            host by the port's reader (data_io/video.py): every frame's
            sha256, the frame count and the fps equal to the JSON beside it
            (cv2.VideoCapture's, held by tests/test_torch_port_video_codec.py),
            host ms a frame for demux, VP8 decode and YUV -> BGR; (b) python
            -m fgvc_tpu_torch.cli.test's main --task kinetics --annotations
            CSV --data-root DIR on a tree holding the clip under one video
            id, with 32 tracks written by the phase, at the paper's
            settings (ResNet-18-d1, 256 x 256, seeded full-width weights):
            K1 (circle) launched once per frame propagated, metrics finite
            and equal exactly to run_task over per-video pickles of the
            port's own decode of the clip and the same tracks; (c) the demo's
            main --video on the clip, --grid 8 (64 points) --max-frames 48:
            K1 (circle) 47 times, an .mp4 of 48 samples; (d)-(f) the same for
            MPEG-4 Part 2: (d) the committed mp4v MP4
            (tests/torch_port_fixtures/mp4v_640x360_250f.mp4, 250 frames,
            cv2's writer) to its cv2 pins with host ms a frame for demux,
            MPEG-4 decode and YUV -> BGR, and before it two fixtures of
            libavcodec's encoder (mp4v_bvop_4mv_176x144.mp4: B-VOPs, 4MV,
            video packets; mp4v_qpel_dp_xvid_96x64.mp4: quarter-pel, data
            partitioning, XviD's IDCT) to their libavcodec plane pins and
            cv2 frame pins; (e)
            --annotations over the mp4v clip, K1 (circle) 249 times, metrics
            equal to the pickle path's; (f) demo --video on
            its first 48 frames, K1 (circle) 47 times; (g)-(i) the same for
            VP9: (g) the committed VP9 WebM
            (tests/torch_port_fixtures/vp9_640x360_250f.webm, 250 frames,
            cv2's 'VP90' writer, two tile columns) to its cv2 pins with host
            ms a frame for demux, VP9 decode and YUV -> BGR, and before it two
            fixtures of libvpx's encoder
            (vp9_altref_compound_tiles_512x128.mkv: alt-ref frames hidden in
            superframes, compound prediction, tile columns, backward
            adaptation; vp9_aq_errres_lossless_bilinear_96x64.mkv:
            segmentation with its temporal map, error resilience, lossless,
            the bilinear filter, show_existing_frame) to their libvpx plane
            pins and cv2 frame pins; (h) --annotations over the VP9 clip, K1
            (circle) 249 times, metrics equal to the pickle path's; (i) demo --video on its first 48 frames, K1 (circle) 47
            times; (j) the committed AVI of cv2's XVID writer
            (tests/torch_port_fixtures/mp4v_640x360_48f.avi, the first 48
            frames of the VP8 clip's content) to its cv2 pins with host ms a
            frame for demux, MPEG-4 decode and YUV -> BGR, then demo --video
            on it, K1 (circle) 47 times; (k) the same for cv2's MJPG AVI
            (mjpg_640x360_48f.avi: Motion-JPEG 4:2:0, FFmpeg's mjpeg decoder's
            planes, swscale's unscaled full-range conversion); (l) the port's
            own save_video .mp4 (mjpg_444_320x180_24f.mp4: 24 frames, 4:4:4
            q95, swscale's full-chroma path) to its cv2 pins, then
            --annotations over two copies of it, K1 (circle) 46 times,
            metrics equal to the pickle path's; (m)-(p) odd frame heights,
            which cv2 converts on swscale's scaling path
            (csrc/swscale.cpp): the committed 24-frame VP8 WebM at 256 x 143
            (cv2's libvpx, its key-frame headers cut to 143 rows), to its
            cv2 pins, then --annotations over two copies of it, K1 (circle)
            46 times, metrics equal to the pickle path's; the VP9 WebM in
            BT.709 at 256 x 143 (libvpx), the mp4v MP4 at 255 x 143 (cv2's
            writer, the VOL cut; full chroma, sited left) and the 12-frame
            Motion-JPEG 4:2:2 AVI at 256 x 143 (PIL's JPEGs) to their cv2
            pins; then host ms to convert a 640 x 359 frame on the scaling
            path beside a 640 x 360 one on the unscaled path (BT.601 4:2:0,
            seeded planes);
  dataprep  the data-preparation tools (fgvc_tpu_torch/tools/data), no cv2:
            (a) a YouTube-VOS tree written by the port's encoder (2 videos x
            6 frames at 720 x 1280, q95, a seeded texture moving by whole
            pixels) through python -m fgvc_tpu_torch.tools.data.prepare_ytv's
            main --size 256 (INTER_AREA to 256 x 455) and (b) pack_frames
            --codec jpeg over its output: the sha256 of each output tree
            equal to DATAPREP_PINS, the JAX tools' (cv2's) on the same tree;
            host ms a frame of the JPEG decode, resize_area, the encode and
            the pack; (c) precompute_flow --iters 30 in both formats over the
            256 x 455 tree with seeded RAFT weights at the official width
            (batch-normed cnet) from a .pth under the official names, on the
            card: every flow (256, 455, 2) and finite, every uint8 file a
            256 x 455 JPEG; one pair's forward and backward flows against
            the same function on the CPU (median |diff| <= 1e-3 px, max <=
            1e-2 px, as phase raft); ms a flow at 256 x 456 (CUDA events),
            the tool's peak device memory; (d) generate_tapvid_kinetics over
            the committed VP8, mp4v and VP9 clips with 32 tracks each and a
            CSV row of a missing clip: exit 0, three pickles, each video
            equal to decode_video's and to the pin of the JAX tool's pickle,
            points and occlusion equal to assemble_tracks'.
The line before the last is a JSON object with each kernel's numbers; the last
line is {"ok": true, "device": {...}}.  Without a CUDA card, or without the
fgvc_tpu_torch package beside this file, it exits with an error.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense bf16 and TF32 on the tensor cores and HBM3 bandwidth; they
# assume the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# SIMT operations (compare, select, max, add) per second: the fp32 peak
# counts an FMA as two
PEAK_SIMT_OPS = PEAK_FP32_FLOPS / 2

# kernel against plain, per query pixel: 'float32' and 'high' to KERNEL_TOL,
# 'bfloat16' to BF16_TOL_REL * max|v|; rows beyond it must be near-tie rows
# (ops/cuda/topk_attention.py near_tie_rows), at most NEAR_TIE_SHARE of them
KERNEL_TOL = 1e-4
BF16_TOL_REL = 2.0 ** -7
NEAR_TIE_SHARE = 1e-3
# K5's cut 'a': live affinities against the plain version, relative to max|a|
AFF_RTOL = 2e-5
# K5's cut 'a' at every column of slot 0's window: Cv = round_up(win, 8)^2
# with win = 16 + 2 * 15 at the tool's shapes
FULL_WINDOW_CV = 48 * 48
# K5's cut 'ab': z against its plain version, relative
Z_RTOL = 1e-5
# the tie-heavy case (exact affinities): the least limit of z and the
# output, relative; only their summation orders differ from the plain
# version's (bench/compare_source.py tie_heavy_limits)
TIE_RTOL = 1e-6
# K6 'mxu' against float32 products: |out| is up to about 60, 3xTF32 keeps
# about 2^-21 of each product
MXU_TOL = 1e-3
# K4: blocks per frame in the kernel phase, per window
ROW_SPLITS = {"circle": (2, 3), "square": (2, 4)}
SP_TRAJ_TOL_PX = 1e-6
TRAJ_TOL_PX = 1e-3
DELTA_D_TOL = 0.1
# share of pixels on which two label maps must agree: banked against save_mem
# (features at batch 16 and at batch 1), and, in 'high' and 'default',
# kernels against plain versions (pass C sums in another order, and a
# bf16-rounded value mix moves a logit further); float32 kernels against
# plain versions agree closer (logits within 2e-7, so a label flips only at a
# near tie)
MASK_AGREE = 0.9999
PLAIN_MASK_AGREE = 0.99999
JF_TOL = 1e-4
# K3 against 'highest' (modes phase) and against its plain versions
PRECISIONS = ("highest", "high", "default")
MODE_TRAJ_TOL_PX = 1e-2
MODE_DELTA_D = {"high": 0.1, "default": 0.5}
MODE_JF_TOL = 0.005
# RAFT (--model raft): final flow of one 256 x 256 pair, card against CPU
# (cuDNN and the CPU sum the convolutions in other orders), and video 0's
# chained trajectories, whose errors grow along the chain
RAFT_FLOW_MEDIAN_PX, RAFT_FLOW_MAX_PX = 1e-3, 1e-2
RAFT_TRAJ_MEDIAN_PX = 1e-2
# heatmap visibility, K1 against its plain version: share of (frame, point)
# pairs whose visibility agrees (a peak ratio may sit at the threshold)
VIS_AGREE = 0.999

# propagation settings of DAVIS_TEST_CFG (ResNet-18-d1 features, C = 256)
C = 256
SLOTS = 6
RADIUS = 15.0
TOPK = 10
TILE = 16
TEMPERATURE = 0.07
# TAP-Vid-DAVIS shapes (256 x 256 input), 32 point maps
H = W = 128
CV = 32
# DAVIS VOS shapes (480 x 880 input), 4 objects + background
VOS_H, VOS_W = 240, 440
VOS_CV = 5
VOS_T, VOS_ORIG, VOS_OBJECTS = 24, (480, 854), 3
# TAP-Vid-Kinetics, strided queries: one 250-frame video stored at 360 x 640
KIN_T, KIN_ORIG, KIN_TRACKS = 250, (360, 640), 32
# JHMDB: 320 x 320 input (160 x 160 features), 15 joints, frames at 240 x 320
JHMDB_H = JHMDB_W = 160
JHMDB_CV, JHMDB_T, JHMDB_VIDEOS, JHMDB_ORIG = 15, 40, 2, (240, 320)
# BADJA: (320, 512) input (160 x 256 features), 20 joints, frames at 1080 x 1920
BADJA_H, BADJA_W = 160, 256
BADJA_CV, BADJA_T, BADJA_EVERY, BADJA_ORIG = 20, 60, 5, (1080, 1920)
# phase codecs: the cross-machine pins, sha256 of the JPEG bytes at quality
# CODEC_PIN_QUALITY and of the decoded pixels of codec_pin_frame(h, w), as
# cv2.imencode and PIL (libjpeg) give them (tests/test_torch_port_codecs.py)
CODEC_PIN_SHAPES = ((256, 256), (480, 854))
CODEC_PIN_QUALITY = 95
CODEC_PINS = {
    "256x256": ("01b56f06e3977f522d57240f79cf07953f4946b00fa7515dd234882e95a8fa8c",
                "9a3379767225c1d0bae25dc39488791cd687d4652ad50d4b512920dce4759f46"),
    "480x854": ("b958cb89e2a1572179deeb3ef5781e6028988c5679a21776e8bbb62756d4fbb7",
                "c47cc3e4d1c24e7284fde1d891b1984f2643f3251397274d6185233c85b0523d"),
}
CODEC_HW, CODEC_FRAMES = (480, 854), 24     # host codec times: a VOS video's frames
# phase codecs (f): the committed fixtures (tests/test_torch_port_codecs_more.py
# makes them with PIL and cv2) and the sha256 of their RGB pixels as PIL and
# cv2 decode them; the EXIF files' frame and the sha256 of cv2.imread's RGB
# of exif_jpeg(frame, exif_tiff(o, little=o % 2 == 1)) for orientation o
FIXTURE_DIR = os.path.join("tests", "torch_port_fixtures")
FIXTURE_PINS = {
    "adam7_rgb_540x960.png": "2ca691e27781fc54db6fe9f70c2501173ed73b37348eb0b39747aa11b73d0053",
    "progressive_420_rst_256x256.jpg":
        "16388e365539026fc88acb3188122341934c68830bb37c77c80b4a0fe4e87f7f",
    "progressive_q95_480x854.jpg":
        "51db63519290f1c4ef94c06d4bd8fae004dc614fed6c82b43bbfc1c433b84308",
    "s411_q75_480x854.jpg": "af3aad0facc5c1247bac8bef6a9ef563fd14846a9fd2de4e49bfeeeee7349fc7",
    "s440_q75_480x854.jpg": "d7ec5099405ca080d6a0c8061725a894efb1b500083a41a66ac1ea70edbe0984",
    "lossy_q90_540x960.webp": "873246679aa68612a4fde51d00b81b0f70fa1206d7be49cd7f4767c83e0af924",
    "lossless_216x384.webp": "812c36575d48742172a266faa1752f58152d49b44961750468c6cababfd802e1",
    "alpha_q80_120x160.webp": "b430698a2823b94ae9653b56a1d9ee6b406e5955296893df372e70f6329c0974",
}
EXIF_HW, EXIF_SEED = (48, 80), 7
EXIF_PINS = {
    1: "025bdf573c274d8f277afb76889718f14eda1a625db2174f9065dbaa5848a8e2",
    2: "65609a54d03f9d00cad333de19bb35d1d4f2562e517566a9378e50e7b674cc77",
    3: "d3856b35f44b9fc364ae9816f9ee3d57d9dc129d3fabeae5d7baaf906726aedd",
    4: "01c34738bcfa3db7ae332154ac60d960959bb76231b4eb9bd6e157ba57d971a1",
    5: "93b0cddf5b5bfa0717d4c8d7b67a6bcb309e881b7b1cc0a5b84bb9b15ec0df51",
    6: "b1412ba43e55e597cdf2a4140f408d22c62e53fa02787645f46ea23b85baef94",
    7: "19437f1c17077d4e4931bce9c2cbbce1f93dd669d58c1388496931ffcbf5d75e",
    8: "5c1a4bdab4739dbd6b949bba8120dbcd1b4aa73650119fb85d6e221aac3c8da4",
}
# the JPEG forms beside the fixtures: PIL's CMYK (decode_jpeg: PIL's 4 channels;
# read_image: cv2's BGR conversion, as RGB) and the progressive fixture cut
# after k of its scans, EOI appended (libjpeg's smoothing; PIL = cv2)
CMYK_FIXTURE = "cmyk_q75_480x854.jpg"
CMYK_DIR = os.path.join("tests", "torch_port_jpeg_forms")
PROGRESSIVE_CUTS = (1, 5)
JPEG_FORM_PINS = {
    "cmyk_pil": "c293917ba7245c25265dfe54138f67881de8222feec4644a1caaa47d5df43fc8",
    "cmyk_cv2": "828f541106f76e2f543ccda6f28ca366e2649aeba758c47e087405a60235099a",
    "progressive_1": "f3e249486dca2ed30e204741f75f26766503b5502adae789eb7c7b9ea1509f9c",
    "progressive_5": "52688ab93d578ccc6f557d8a0faf38881dfe4354b8cae8640890f2958f0f5c6f",
}
PACK_FRAMES, PACK_HW = 250, (256, 256)      # FgPack.read_batch MB/s


def codec_pin_frame(h, w, seed=0):
    """A seeded (h, w, 3) uint8 frame made with integer arithmetic only, so
    every machine makes the same bytes: 8 x 8 random cells, box-blurred over
    9 x 9 pixels, plus noise in [-6, 6]."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3), dtype=np.int64)
    up = np.repeat(np.repeat(cells, 8, axis=0), 8, axis=1)[:h + 8, :w + 8]
    c = np.pad(up, ((1, 0), (1, 0), (0, 0))).cumsum(axis=0).cumsum(axis=1)
    box = (c[9:h + 9, 9:w + 9] - c[:h, 9:w + 9] - c[9:h + 9, :w] + c[:h, :w]) // 81
    noise = rng.integers(-6, 7, (h, w, 3))
    return np.clip(box + noise, 0, 255).astype(np.uint8)
def exif_tiff(orientation, little=True):
    """A TIFF header whose IFD0 holds Orientation and ImageLength entries."""
    import struct

    e = "<" if little else ">"
    entries = (struct.pack(e + "HHIH", 0x0112, 3, 1, orientation) + b"\0\0"
               + struct.pack(e + "HHII", 0x0101, 4, 1, 40))
    return ((b"II*\0" if little else b"MM\0*") + struct.pack(e + "IH", 8, 2) + entries
            + struct.pack(e + "I", 0))


def exif_jpeg(img, tiff):
    """The port's quality-95 JPEG of img with an APP1 'Exif' segment holding
    `tiff` spliced in after its SOI and 18-byte JFIF APP0."""
    import struct

    from fgvc_tpu_torch.data_io.fgpack import encode_jpeg

    jpg = encode_jpeg(img, 95)
    body = b"Exif\0\0" + tiff
    return jpg[:20] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + jpg[20:]


# the zoo (--backbone) beside ResNet-18-d1, and the K1 shapes it brings:
# record -> (entry, h, w, C, Cv, window) at TAP-Vid's 256 x 256 and VOS's
# 480 x 880
ZOO_ENTRIES = ("dino_vit_s8", "dino_vit_s16", "dino_vit_b8", "vit_small_d8", "swin_tiny",
               "hrnet_w18", "resnet18_mast", "resnet18_pos")
ZOO_SHAPES = {
    "K1_circle_dino_s8": ("dino_vit_s8", 32, 32, 384, CV, "circle"),
    "K1_circle_dino_b8": ("dino_vit_b8", 32, 32, 768, CV, "circle"),
    "K1_circle_hrnet": ("hrnet_w18", 8, 8, 144, CV, "circle"),
    "K1_square_vos_b8": ("dino_vit_b8", VOS_H // 4, VOS_W // 4, 768, VOS_CV, "square"),
    # JHMDB's 320 x 320 input at stride 16 (the ResNet's 160 x 160 over 8)
    "K1_square_jhmdb_s16": ("dino_vit_s16", JHMDB_H // 8, JHMDB_W // 8, 384, JHMDB_CV,
                            "square"),
}


_PHASE = {"name": None, "t": 0.0, "seconds": {}}


def phase(name):
    """Print the phase's header, and the seconds the one before it took."""
    now = time.time()
    if _PHASE["name"] is not None:
        print(f"-- {_PHASE['name']} took {now - _PHASE['t']:.1f} s", flush=True)
        _PHASE["seconds"][_PHASE["name"]] = round(now - _PHASE["t"], 1)
    _PHASE.update(name=name, t=now)
    if name is not None:
        print(f"== {name}", flush=True)


def card_info() -> str:
    from fgvc_tpu_torch.utils.env import card_info as query

    card = query()
    if card is None:
        raise RuntimeError("nvidia-smi reads no card")
    return card


def ptxas_usage(log):
    """[(kernel, 'registers, shared memory, spills')] from nvcc -Xptxas -v
    output, the kernels' names demangled where c++filt is at hand."""
    usage, name, spills = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            usage.append([name, line.split("Used", 1)[1].strip() + "; " + spills])
    try:
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in usage),
                               capture_output=True, text=True, timeout=30).stdout.split("\n")
        for u, n in zip(usage, names):
            u[0] = n.replace("(anonymous namespace)::", "").split("(")[0] or u[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return usage


def build_kernels():
    from fgvc_tpu_torch.ops.cuda.build import CSRC_DIR, build_all

    names = sorted(p[:-3] for p in os.listdir(CSRC_DIR) if p.endswith(".cu"))
    t0 = time.time()
    logs = build_all(names)
    dt = time.time() - t0
    for name, log in logs.items():
        usage = ptxas_usage(log)
        print(f"built {name}.cu" + ("" if usage else ": cached"))
        for kernel, line in usage:
            print(f"  ptxas {kernel}: {line}")
    print(f"build time {dt:.1f} s for {len(names)} source(s)", flush=True)


def _events_ms(fn, reps):
    """Median device ms of fn() over reps calls (CUDA events)."""
    from fgvc_tpu_torch.utils.profiler import events_ms

    return events_ms(fn, reps)


def device_ms_by_kernel(fn):
    """Run fn under torch.profiler; {CUDA kernel name: device ms} and the
    wall ms of the run (empty dict where the profiler saw no device time)."""
    from fgvc_tpu_torch.utils.profiler import device_ms_by_kernel as profiled

    return profiled(fn)


def _top(ms_by_name, n=6):
    items = sorted(ms_by_name.items(), key=lambda kv: -kv[1])[:n]
    return ", ".join(f"{name[:60]} {ms:.2f} ms" for name, ms in items)


def live_pairs(h, w, mask_shape, rows=None):
    """(query, key) pairs of one key slot inside the radius window and the
    image, over an h x w grid, or over its query rows [r0, r1) where `rows`
    is given (a row block)."""
    halo, r = int(RADIUS), RADIUS
    r0, r1 = (0, h) if rows is None else rows
    n = 0
    for dy in range(-halo, halo + 1):
        for dx in range(-halo, halo + 1):
            inside = (abs(dy) <= r and abs(dx) <= r) if mask_shape == "square" \
                else dy * dy + dx * dx < r * r
            if inside:  # query rows y in [r0, r1) with 0 <= y, y + dy < h
                ys = min(r1, h, h - dy) - max(r0, 0, -dy)
                n += max(ys, 0) * max(w - abs(dx), 0)
    return n


def attention_bound(h, w, mask_shape, key_valid, nbytes, mode="float32", rows=None, c=C):
    """Least time for one top-k attention call on these inputs: the larger
    of the live affinity products (in-window, in-image, valid-slot pairs,
    of the query rows `rows` where given; 2 * c flops each; 'float32' three
    TF32 products each (3xTF32) over the TF32 tensor-core peak, 'high' three
    bf16 products each and 'bfloat16' one over the bf16 tensor-core peak)
    and `nbytes` (each input read once, the output written once) over the
    HBM rate."""
    flops = 2.0 * c * live_pairs(h, w, mask_shape, rows) * sum(bool(v) for v in key_valid)
    if mode != "bfloat16":
        flops *= 3
    peak = PEAK_TF32_FLOPS if mode == "float32" else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


# the kernel phase's cases: key frames, slot validity and query frame of
# distinct key frames and of the step t = 1 (frame 0 in slot 0 and slot 5,
# the rest before the video)
FIDX = {"distinct": list(range(SLOTS)), "t1_tie": [0] * SLOTS}
VALID = {"distinct": [True] * SLOTS, "t1_tie": [True] + [False] * (SLOTS - 2) + [True]}
QFRAME = {"distinct": SLOTS, "t1_tie": 1}


# record tags of the compute modes
_TAG = {"float32": "f32", "high": "high", "bfloat16": "bf16"}


def record_key(entry, mode):
    """Record of an entry ('circle', 'square': banked; 'unbanked') in a
    compute mode."""
    if mode == "float32":
        return {"circle": "K1_circle", "square": "K1_square", "unbanked": "K2"}[entry]
    return f"K3_{'bf16' if mode == 'bfloat16' else mode}_{entry}"


def kernel_record(name, replaces, source="fgvc_tpu_torch/csrc/topk_attention.cu",
                  affinity=True):
    record = {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": None, "max_abs_err": None, "ms": None, "plain_ms": None,
        "bound_ms": None, "bound_by": None,
        "library_ms": None,  # no single PyTorch call computes this function
    }
    if affinity:  # affinity_kernel's and select_kernel's own device ms per launch
        record.update(affinity_device_ms=None, select_device_ms=None, select_bound_ms=None)
    return record


def mode_limit(mode, value):
    """The kernel-against-plain limit of a compute mode on these values."""
    if mode == "bfloat16":
        return BF16_TOL_REL * float(value.abs().max())
    return KERNEL_TOL


def check_rows(label, out, ref, limit, near_fn):
    """Each query pixel's output (the last axis: its channels) against the
    plain version's: rows beyond `limit` must be near-tie rows of the plain
    affinities (near_fn(), a boolean map, asked only when some row is beyond
    the limit) and at most NEAR_TIE_SHARE of the rows.  Returns max |diff|."""
    d = (out - ref).abs().amax(-1)
    beyond = d > limit
    n_beyond, rows = int(beyond.sum()), beyond.numel()
    far = 0
    if n_beyond:
        far = int((beyond & ~near_fn().to(beyond.device)).sum())
    err = float(d.max())
    print(f"{label}: max |kernel - plain| = {err:.3e}; {n_beyond} of {rows} rows beyond "
          f"{limit:.3e} ({n_beyond - far} near-tie rows, {far} others; at most "
          f"{NEAR_TIE_SHARE * rows:.0f} near-tie rows allowed)", flush=True)
    if far or n_beyond > NEAR_TIE_SHARE * rows or not err == err:
        raise AssertionError(f"{label}: kernel disagrees with plain version")
    return err


def affinity_ms(by_kernel, reps, kernel="affinity_kernel"):
    """`kernel`'s device ms per launch from a torch.profiler table of `reps`
    launches (None where the profiler saw no device time)."""
    ms = [t for name, t in by_kernel.items() if kernel in name]
    return sum(ms) / reps if ms else None


def select_bound(h, w, cv, rows=None, values=True):
    """Least time of one select_kernel launch: its bytes over the HBM rate,
    each read once: the scratch rows of the h x w query pixels (of those in
    the row block [r0, r1) where `rows` is given; the grid's padding is not
    read), the values (their rows within the halo of the block) unless
    `values` is False (cut 'ab' reads none), and the output.  Its rounds and
    gather are a few hundred operations a row."""
    halo = int(RADIUS)
    win = TILE + 2 * halo
    r0, r1 = (0, h) if rows is None else rows
    n = max(min(r1, h) - r0, 0) * w  # query pixels read
    vrows = min(r1 + halo, h) - max(r0 - halo, 0)
    nbytes = 4.0 * (n * SLOTS * win * win + (SLOTS * vrows * w * cv if values else 0) + n * cv)
    return 1e3 * nbytes / PEAK_BYTES


def check_entry(label, record, kernel_fn, plain_fn, near_fn, cases, h, w, mask_shape, nbytes,
                mode, c=C):
    """Kernel against plain on each case {name: (kwargs, key_valid)}; the
    first case is timed and bounded (c key channels)."""
    import torch

    errs = []
    for i, (name, (kw, valid)) in enumerate(cases.items()):
        out = kernel_fn(**kw)
        ref = plain_fn(**kw)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"{label} {name}: non-finite output")
        errs.append(check_rows(f"{label} {name}", out, ref, mode_limit(mode, kw["value"]),
                               lambda: near_fn(**kw)))
        if i:
            continue
        del out, ref
        ms = _events_ms(lambda: kernel_fn(**kw), 20)
        plain_ms = _events_ms(lambda: plain_fn(**kw), 3)
        bound_ms, bound_by, flops = attention_bound(h, w, mask_shape, valid, nbytes, mode, c=c)
        halo = int(RADIUS)
        win = TILE + 2 * halo
        hp, wp = -(-h // TILE) * TILE, -(-w // TILE) * TILE
        dense = 2.0 * c * hp * wp * len(valid) * win * win  # the halo windows computed
        print(f"{label} {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP live, "
              f"{dense / 1e9:.2f} GFLOP in dense halo windows, {nbytes / 1e9:.3f} GB), "
              f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s of live work"
              f"{'' if mode == 'bfloat16' else ' (3 products a pair)'}", flush=True)
        record.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        reps = 5
        by_kernel, _ = device_ms_by_kernel(lambda: [kernel_fn(**kw) for _ in range(reps)])
        record.update(affinity_device_ms=affinity_ms(by_kernel, reps),
                      select_device_ms=affinity_ms(by_kernel, reps, "select_kernel"),
                      select_bound_ms=select_bound(h, w, kw["value"].shape[-1]))
        print(f"{label} device ms per launch by CUDA kernel (torch.profiler): " + (
            _top({n: t / reps for n, t in by_kernel.items()}) or "not measured")
            + f"; select_kernel bound {record['select_bound_ms']:.4f} ms (bytes)")
    record["max_abs_err"] = max(errs)


def check_tie_exact(label, query, key0, mask_shape, mode):
    """The t = 1 tie case through cut 'ab' (K5) of the unbanked entry: key
    frame 0 in slots 0 and T - 1, both valid.  Each key ties with its copy
    only if both slots sum its affinity bit for bit, so the counts above and
    at the threshold are even on every row."""
    import torch

    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    value = torch.zeros((SLOTS, *query.shape[:2], k1.N_STATS), device=query.device)
    stats = k1.topk_attention(query, key0.expand(SLOTS, *key0.shape[1:]).contiguous(), value,
                              radius=RADIUS, temperature=TEMPERATURE, topk=TOPK,
                              normalize=False, tile=TILE, mask_shape=mask_shape,
                              key_valid=VALID["t1_tie"], compute_dtype=mode, debug_passes="ab")
    odd = int((stats[..., 4:6] % 2 != 0).sum())
    print(f"{label} t1_tie exact: rows with an odd count above or at the threshold: {odd} "
          f"(must be 0)", flush=True)
    if odd:
        raise AssertionError(f"{label}: a frame in two slots does not tie exactly")


def check_tie_heavy():
    """The tie-heavy case with exact affinities (integer features on a few
    channels, no normalisation, temperature 1: bench/compare_source.py's
    integer_tie_inputs) through the unbanked entry in each compute mode, at
    TAP-Vid shapes (circle) and VOS shapes (square): every mode computes
    the affinities exactly, so the kernel's scratch equals the plain
    version's affinities.  Cut 'ab': thresh, mmax, frac, n_above and cnt_at
    equal the plain version's; z and the whole kernel's output within the
    float32 bound of their summation order (tie_heavy_limits: at least 1e-6
    relative, more on rows that sum thousands of tied keys)."""
    import torch

    from fgvc_tpu_torch.bench.compare_source import (
        integer_tie_inputs,
        tie_heavy_kwargs,
        tie_heavy_limits,
    )
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    for name, h, w, cv, shape in (("TAP-Vid", H, W, CV, "circle"),
                                  ("VOS", VOS_H, VOS_W, VOS_CV, "square")):
        q, k, v = (torch.from_numpy(x).cuda() for x in integer_tie_inputs(h, w, cv=cv))
        six = torch.zeros((SLOTS, h, w, k1.N_STATS), device=v.device)
        for mode in k1.COMPUTE_DTYPES:
            label = f"tie-heavy {name} {shape} '{mode}'"
            kw = tie_heavy_kwargs(shape, mode, "ab")  # all six statistics
            out, ref = (k1.topk_attention(q, k, six, **kw),
                        k1.topk_attention_plain(q, k, six, **kw))
            kw = tie_heavy_kwargs(shape, mode, "abc")
            mix, mix_ref = (k1.topk_attention(q, k, v, **kw),
                            k1.topk_attention_plain(q, k, v, **kw))
            torch.cuda.synchronize()
            exact = {n: int((out[..., i] != ref[..., i]).sum())
                     for i, n in ((0, "thresh"), (1, "mmax"), (3, "frac"), (4, "n_above"),
                                  (5, "cnt_at"))}
            z_rtol, mix_limit = tie_heavy_limits(ref, mode, TOPK)
            z_rel = ((out[..., 2] - ref[..., 2]).abs() / ref[..., 2].abs()).max().item()
            mix_rel = (mix - mix_ref).abs().amax(-1) / v.abs().max()
            over = int((mix_rel > mix_limit).sum())
            ties = int((ref[..., 5] > 1).sum())
            print(f"{label}: pixels differing from plain {exact} (all must be 0); z max rel "
                  f"diff {z_rel:.3e} (limit {z_rtol:.3e}); output max |diff| / max |v| "
                  f"{mix_rel.max().item():.3e}, {over} rows over their limit (at least "
                  f"{TIE_RTOL:.0e}, up to {mix_limit.max().item():.3e} on the row summing the "
                  f"most terms); {ties} of {h * w} rows tie at the threshold, at most "
                  f"{int(ref[..., 5].max())} keys", flush=True)
            if any(exact.values()) or not z_rel <= z_rtol or over:
                raise AssertionError(f"{label}: the kernel's statistics or output differ")
        del q, k, v, six
        torch.cuda.empty_cache()


def check_kernels(records):
    """In each compute mode: the banked entry with the circle window at
    TAP-Vid shapes, with the square window and the unbanked entry at DAVIS
    VOS shapes, each for distinct key frames (query frame 6) and the step
    t = 1 (frame 0 in slot 0 and slot 5, the rest before the video)."""
    import torch

    from fgvc_tpu_torch.ops.attention import l2_normalize
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    fidx, valid, qframe = FIDX, VALID, QFRAME
    rng = np.random.default_rng(0)
    for h, w, cv, entries in ((H, W, CV, ("circle",)),
                              (VOS_H, VOS_W, VOS_CV, ("square", "unbanked"))):
        feats = torch.from_numpy(rng.standard_normal((SLOTS + 1, h, w, C), dtype=np.float32)).cuda()
        value = rng.random((SLOTS, h, w, cv), dtype=np.float32)
        values = {"distinct": torch.from_numpy(value).cuda(),
                  "t1_tie": torch.from_numpy(np.concatenate([value[:-1], value[:1]])).cuda()}
        halo, hp, wp, rows_total, cols_total = k1.bank_geometry(h, w, RADIUS, TILE)
        # the save_mem scan's call, and the tie check's: pre-normalised
        # float32 features, raw keys
        nf = l2_normalize(feats)
        for mode in k1.COMPUTE_DTYPES:
            check_tie_exact(f"{'TAP-Vid' if h == H else 'VOS'} '{mode}'", nf[qframe["t1_tie"]],
                            nf[:1], entries[0], mode)
            kpad = k1.pad_key_bank(feats, RADIUS, tile=TILE, compute_dtype=mode)
            esize = kpad.element_size()  # query and bank bytes per element
            for entry in entries:
                key = record_key(entry, mode)
                if entry == "unbanked":
                    cases = {c: (dict(query=nf[qframe[c]], key=nf[fidx[c]], value=values[c],
                                      radius=RADIUS, temperature=TEMPERATURE, topk=TOPK,
                                      normalize=False, tile=TILE, mask_shape="square",
                                      key_valid=valid[c], compute_dtype=mode), valid[c])
                             for c in fidx}
                    # its inputs are the float32 query and keys, in every mode
                    nbytes = 4.0 * (h * w * C + SLOTS * h * w * C + SLOTS * h * w * cv
                                    + h * w * cv)
                    check_entry(f"{key} square", records[key], k1.topk_attention,
                                k1.topk_attention_plain, k1.near_tie_rows_plain_unbanked, cases,
                                h, w, "square", nbytes, mode)
                    continue
                cases = {c: (dict(qpad=kpad[qframe[c], halo:halo + hp, halo:halo + wp].contiguous(),
                                  kpad=kpad, value=values[c], frame_idx=fidx[c],
                                  key_valid=valid[c], H=h, W=w, radius=RADIUS,
                                  temperature=TEMPERATURE, topk=TOPK, tile=TILE,
                                  mask_shape=entry, compute_dtype=mode), valid[c])
                         for c in fidx}
                # query, the distinct key frames of the padded bank, values, output
                nbytes = (esize * (hp * wp * C + SLOTS * rows_total * cols_total * C)
                          + 4.0 * (SLOTS * h * w * cv + h * w * cv))
                check_entry(key, records[key], k1.topk_attention_banked,
                            k1.topk_attention_banked_plain, k1.near_tie_rows_plain, cases, h, w,
                            entry, nbytes, mode)
            del kpad
        del feats, nf, values
        torch.cuda.empty_cache()


def check_shape_kernels(records, shapes, seed, modes=("float32",)):
    """K1 at each of `shapes` {record: (label, h, w, C, Cv, window)}: in
    'float32' for distinct key frames and the step t = 1, held to the plain
    version by the near-tie rule, timed and bounded into the record; in the
    other `modes` for distinct key frames by the same rule."""
    import torch

    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    rng = np.random.default_rng(seed)
    for key, (label, h, w, c, cv, shape) in shapes.items():
        feats = torch.from_numpy(rng.standard_normal((SLOTS + 1, h, w, c), dtype=np.float32)).cuda()
        value = rng.random((SLOTS, h, w, cv), dtype=np.float32)
        values = {"distinct": torch.from_numpy(value).cuda(),
                  "t1_tie": torch.from_numpy(np.concatenate([value[:-1], value[:1]])).cuda()}
        halo, hp, wp, rows_total, cols_total = k1.bank_geometry(h, w, RADIUS, TILE)
        for mode in modes:
            kpad = k1.pad_key_bank(feats, RADIUS, tile=TILE, compute_dtype=mode)
            cases = {c_: (dict(qpad=kpad[QFRAME[c_], halo:halo + hp, halo:halo + wp].contiguous(),
                               kpad=kpad, value=values[c_], frame_idx=FIDX[c_],
                               key_valid=VALID[c_], H=h, W=w, radius=RADIUS,
                               temperature=TEMPERATURE, topk=TOPK, tile=TILE, mask_shape=shape,
                               compute_dtype=mode), VALID[c_])
                     for c_ in FIDX}
            if mode == "float32":
                nbytes = 4.0 * (hp * wp * c + SLOTS * rows_total * cols_total * c
                                + SLOTS * h * w * cv + h * w * cv)
                check_entry(label, records[key], k1.topk_attention_banked,
                            k1.topk_attention_banked_plain, k1.near_tie_rows_plain, cases, h, w,
                            shape, nbytes, mode, c=c)
                continue
            kw = cases["distinct"][0]
            out, ref = k1.topk_attention_banked(**kw), k1.topk_attention_banked_plain(**kw)
            torch.cuda.synchronize()
            check_rows(f"{label} '{mode}' distinct", out, ref, mode_limit(mode, kw["value"]),
                       lambda: k1.near_tie_rows_plain(**kw))
            del out, ref
        del feats, values, kpad, cases
        torch.cuda.empty_cache()


def check_heatmap_kernels(records):
    """K1 with the square window at the keypoint tasks' shapes: JHMDB (160 x
    160, 15 values) and BADJA (160 x 256, 20 values)."""
    check_shape_kernels(records, {
        key: (f"{key} {h}x{w} Cv {cv}", h, w, C, cv, "square")
        for key, h, w, cv in (("K1_square_jhmdb", JHMDB_H, JHMDB_W, JHMDB_CV),
                              ("K1_square_badja", BADJA_H, BADJA_W, BADJA_CV))}, seed=2)


def check_zoo_kernels(records):
    """K1 at the zoo's shapes (ZOO_SHAPES: C = 384, 768 and 144, grids from
    8 x 8, one partial tile, to 60 x 110), in every compute mode."""
    from fgvc_tpu_torch.ops.cuda.topk_attention import COMPUTE_DTYPES

    check_shape_kernels(records, {
        key: (f"{key} ({entry}) {h}x{w}x{c} Cv {cv} {shape}", h, w, c, cv, shape)
        for key, (entry, h, w, c, cv, shape) in ZOO_SHAPES.items()}, seed=3,
        modes=COMPUTE_DTYPES)


def row_blocks(h, S):
    """(hb, gridH, row0 of each block): Tracker.row_blocks for S blocks."""
    hb = -(-(-(-h // TILE) * TILE // S) // TILE) * TILE
    return hb, S * hb, [i * hb for i in range(S)]


def check_row_blocks(records):
    """K4 in each compute mode: the banked entry's row blocks over a bank
    over-padded to S blocks, with the circle window at TAP-Vid shapes and
    the square window at VOS shapes; distinct key frames at every S and the
    t = 1 tie at S = 2.  Each block against its plain version; the gathered
    blocks against the unsharded call bit for bit.  In 'float32' a frame's
    S blocks are timed against the unsharded call; S = 2 per block launch
    (all S blocks over S), bounded by the mean of its blocks' bounds."""
    import torch

    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    rng = np.random.default_rng(1)
    for h, w, cv, shape in ((H, W, CV, "circle"), (VOS_H, VOS_W, VOS_CV, "square")):
        feats = torch.from_numpy(rng.standard_normal((SLOTS + 1, h, w, C), dtype=np.float32)).cuda()
        value = rng.random((SLOTS, h, w, cv), dtype=np.float32)
        values = {"distinct": torch.from_numpy(value).cuda(),
                  "t1_tie": torch.from_numpy(np.concatenate([value[:-1], value[:1]])).cuda()}
        halo, hp, wp, _, cols_total = k1.bank_geometry(h, w, RADIUS, TILE)
        record = records[f"K4_{shape}"]
        for mode in k1.COMPUTE_DTYPES:
            kpad = k1.pad_key_bank(feats, RADIUS, tile=TILE, compute_dtype=mode)
            kw = dict(H=h, W=w, radius=RADIUS, temperature=TEMPERATURE, topk=TOPK, tile=TILE,
                      mask_shape=shape, compute_dtype=mode)
            for S in ROW_SPLITS[shape]:
                hb, grid, row0s = row_blocks(h, S)
                tall = k1.pad_key_bank(feats, RADIUS, tile=TILE, compute_dtype=mode,
                                       grid_rows=grid)
                for case in (("distinct", "t1_tie") if S == 2 else ("distinct",)):
                    label = f"K4 {shape} '{mode}' S={S} {case}"
                    args = dict(value=values[case], frame_idx=FIDX[case], key_valid=VALID[case],
                                **kw)
                    unsharded = dict(qpad=kpad[QFRAME[case], halo:halo + hp,
                                               halo:halo + wp].contiguous(), kpad=kpad, **args)
                    full = k1.topk_attention_banked(**unsharded)
                    blocks = [dict(qpad=tall[QFRAME[case], halo + r0:halo + r0 + hb,
                                             halo:halo + wp].contiguous(),
                                   kpad=tall, row0=r0, grid_rows=grid, **args) for r0 in row0s]
                    outs = [k1.topk_attention_banked(**b) for b in blocks]
                    torch.cuda.synchronize()
                    if not all(torch.isfinite(o).all() for o in outs):
                        raise AssertionError(f"{label}: non-finite output")
                    limit = mode_limit(mode, args["value"])
                    errs = [check_rows(f"{label} block row0={b['row0']}", o,
                                       k1.topk_attention_banked_plain(**b), limit,
                                       lambda b=b: k1.near_tie_rows_plain(**b))
                            for o, b in zip(outs, blocks)]
                    gathered = torch.cat(outs)[:h]
                    d = (gathered - full).abs().max().item()
                    print(f"{label}: hb {hb}, grid {grid}; gathered vs unsharded "
                          f"max |diff| {d:.3e} (must be 0)", flush=True)
                    if not torch.equal(gathered, full):
                        raise AssertionError(f"{label}: gathered blocks differ from unsharded")
                    if mode == "float32":
                        record["max_abs_err"] = max(record["max_abs_err"] or 0.0, *errs)
                    if mode != "float32" or case != "distinct":
                        continue
                    del outs, gathered
                    # a frame on one card: its S blocks against the unsharded call
                    frame_ms = _events_ms(
                        lambda: [k1.topk_attention_banked(**b) for b in blocks], 20)
                    full_ms = _events_ms(lambda: k1.topk_attention_banked(**unsharded), 20)
                    print(f"{label}: a frame in {S} blocks {frame_ms:.3f} ms, unsharded "
                          f"{full_ms:.3f} ms ({100 * (frame_ms / full_ms - 1):+.1f}%; {grid} "
                          f"grid rows for {hp})", flush=True)
                    if S != 2:
                        continue
                    ms = frame_ms / S
                    plain_ms = _events_ms(
                        lambda: [k1.topk_attention_banked_plain(**b) for b in blocks], 3) / S
                    bounds = []
                    for r0 in row0s:
                        r1 = min(r0 + hb, h)
                        key_rows = hb + 2 * halo
                        # query block, its bank rows of each slot frame, its
                        # values' rows, the block's output
                        nbytes = 4.0 * (hb * wp * C + SLOTS * key_rows * cols_total * C
                                        + SLOTS * (min(r1 + halo, h) - max(r0 - halo, 0)) * w * cv
                                        + hb * w * cv)
                        bounds.append(attention_bound(h, w, shape, VALID[case], nbytes, mode,
                                                      rows=(r0, r0 + hb)))
                    bound_ms = sum(b[0] for b in bounds) / S
                    flops = sum(b[2] for b in bounds) / S
                    bound_by = bounds[0][1]
                    tiles = (hb // TILE) * (wp // TILE)
                    scratch = tiles * TILE * TILE * SLOTS * (TILE + 2 * halo) ** 2
                    print(f"{label}: kernel {ms:.3f} ms per block launch, plain {plain_ms:.3f} ms, "
                          f"bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP live per "
                          f"block); scratch {4.0 * scratch / 1e9:.2f} GB per block launch",
                          flush=True)
                    record.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
                    reps = 5
                    by_kernel, _ = device_ms_by_kernel(
                        lambda: [k1.topk_attention_banked(**b) for _ in range(reps) for b in blocks])
                    record.update(
                        affinity_device_ms=affinity_ms(by_kernel, reps * S),
                        select_device_ms=affinity_ms(by_kernel, reps * S, "select_kernel"),
                        select_bound_ms=sum(select_bound(h, w, cv, rows=(r0, r0 + hb))
                                            for r0 in row0s) / S)
                    print(f"{label}: device ms per block launch (torch.profiler): affinity_kernel "
                          f"{record['affinity_device_ms']}, select_kernel "
                          f"{record['select_device_ms']} (bound {record['select_bound_ms']:.4f}, "
                          f"bytes)", flush=True)
                del tall
            del kpad
        del feats, values
        torch.cuda.empty_cache()


def _texture(rng, size):
    """Smooth random RGB texture (low-passed noise), uint8."""
    noise = rng.standard_normal((size, size, 3))
    f = np.fft.fft2(noise, axes=(0, 1))
    k = np.fft.fftfreq(size)
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    tex = np.real(np.fft.ifft2(f * np.exp(-k2 * 2000.0)[..., None], axes=(0, 1)))
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    return (tex * 255).astype(np.uint8)


def make_tapvid_pickles(root, n_videos=2, T=48, size=256, n_tracks=32, seed=0):
    """Per-video pickles of a texture panning at a random velocity; tracks
    follow the pan and are occluded outside the frame.  A quarter of the
    tracks are hidden until frame 10 or 20, so their queries form later
    groups."""
    rng = np.random.default_rng(seed)
    margin = 2 * T
    for vi in range(n_videos):
        tex = _texture(rng, size + 2 * margin)
        vel = rng.uniform(-1.5, 1.5, 2)
        off = np.round(np.arange(T)[:, None] * vel[None]).astype(int) + margin
        video = np.stack([tex[oy:oy + size, ox:ox + size] for ox, oy in off])
        p0 = rng.uniform(16, size - 16, (n_tracks, 2))
        pts = p0[:, None, :] - (off - off[0])[None].astype(np.float64)
        occ = (pts < 0).any(-1) | (pts > size - 1).any(-1)
        q = n_tracks // 8
        occ[-2 * q:-q, :10] = True
        occ[-q:, :20] = True
        with open(os.path.join(root, f"video_{vi:02d}.pkl"), "wb") as f:
            pickle.dump({"video": video, "points": (pts / size).astype(np.float32),
                         "occluded": occ}, f)


def frames_propagated(ds):
    total = 0
    for i in range(len(ds)):
        s = ds[i]
        T = len(s["video"])
        total += sum(T - int(t) - 1 for t in np.unique(s["query_points"][:, 0].astype(int)))
    return total


def check_metrics(metrics):
    for k in ("average_pts_within_thresh", "pts_within_1", "pts_within_16"):
        if not np.isfinite(metrics[k]):
            raise AssertionError(f"metric {k} is not finite: {metrics[k]}")


def check_launches(label, precision, expect, entry):
    """Every launch since the last reset was of `entry` ('banked',
    'unbanked' or 'row_block') in the compute mode of `precision`, `expect`
    of them (one per frame propagated, S per frame for row blocks)."""
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    mode = k1.pallas_compute_dtype(precision)
    counts = {"banked": k1.launches, "unbanked": k1.unbanked_launches,
              "row_block": k1.row_block_launches}
    got = (counts, dict(k1.mode_launches))
    want = ({e: expect if e == entry else 0 for e in counts},
            {m: expect if m == mode else 0 for m in k1.mode_launches})
    print(f"{label}: launches by entry {got[0]}, by mode {got[1]} (expected {expect} {entry})",
          flush=True)
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def run_e2e(data_root, record):
    import torch

    from fgvc_tpu_torch.apis.test import run_task
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ds = TapVidDataset(data_root)
    expect = frames_propagated(ds)
    n_frames = sum(len(ds[i]["video"]) for i in range(len(ds)))

    k1.reset_launches()
    t0 = time.time()
    metrics = run_task("davis", data_root, device="cuda", seed=0)
    torch.cuda.synchronize()
    dt = time.time() - t0
    check_launches("e2e", "highest", expect, "banked")
    check_metrics(metrics)
    record["launches"] = expect
    print("TAP-Vid metrics (random weights): " + json.dumps(
        {k: metrics[k] for k in ("average_pts_within_thresh", "average_jaccard",
                                 "occlusion_accuracy", "pts_within_1", "pts_within_4",
                                 "pts_within_16")}))
    print(f"e2e: {len(ds)} videos, {n_frames} frames in {dt:.2f} s = "
          f"{n_frames / dt:.2f} frames/s (model build and data reading included)")
    return metrics


def run_plain_comparison(data_root):
    import torch

    from fgvc_tpu_torch.apis.test import build_tracker
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ds = TapVidDataset(data_root)
    s = ds[0]
    tracker = build_tracker(seed=0, device="cuda")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    feats, t_feat = timed(lambda: tracker.extract_features(s["video"]))
    n0 = k1.launches
    out_k, t_prop = timed(lambda: tracker.track_points(s["video"], s["query_points"], feats=feats))
    n_k = k1.launches - n0
    by_kernel, wall_ms = device_ms_by_kernel(
        lambda: tracker.track_points(s["video"], s["query_points"]))
    busy = sum(by_kernel.values())
    if busy:
        print(f"video 0 profiled (features + propagation + decode): wall {wall_ms:.1f} ms, "
              f"device busy {busy:.1f} ms ({100 * busy / wall_ms:.1f}%); top kernels: "
              + _top(by_kernel))
    else:
        print("video 0 profile: device time not measured by torch.profiler")
    out_p, t_plain = _plain_propagation(
        lambda: timed(lambda: tracker.track_points(s["video"], s["query_points"], feats=feats)))
    T = len(s["video"])
    print(f"video 0 ({T} frames): features {1e3 * t_feat:.1f} ms, propagation+decode "
          f"{1e3 * t_prop:.1f} ms with K1 ({n_k} launches), {1e3 * t_plain:.1f} ms "
          f"with the plain version")
    diff = np.abs(out_k["trajectories"] - out_p["trajectories"])
    med = float(np.median(diff))
    res = [_score(ds, s, out)["average_pts_within_thresh"] for out in (out_k, out_p)]
    print(f"kernel vs plain trajectories: median |diff| {med:.3e} px, max {diff.max():.3e} px; "
          f"<D {res[0]:.4f} vs {res[1]:.4f}", flush=True)
    if not med <= TRAJ_TOL_PX:
        raise AssertionError(f"median trajectory difference {med} px > {TRAJ_TOL_PX}")
    if not abs(res[0] - res[1]) <= DELTA_D_TOL:
        raise AssertionError(f"<D differs by {abs(res[0] - res[1])} > {DELTA_D_TOL}")


class SyntheticDavis:
    """DAVIS-like videos made in numpy: a panning texture at the original
    size with VOS_OBJECTS textured ellipses moving over it (a later object
    hides an earlier one), resized to 480 x 880 as the DAVIS reader does.
    The reader's interface: __len__, __getitem__ and score_video, which
    also keeps each video's predicted label maps."""

    def __init__(self, n_videos=2, T=VOS_T, orig=VOS_ORIG, seed=0):
        from fgvc_tpu_torch.datasets.davis_vos import INPUT_SIZE, resize_frames

        rng = np.random.default_rng(seed)
        h0, w0 = orig
        orig = np.array(orig, dtype=np.float64)
        margin = 2 * T
        yy, xx = np.mgrid[:h0, :w0]
        # frames at the original size, at the reader's size, label maps
        self.originals, self.videos, self.gt, self.preds = [], [], [], {}
        for _ in range(n_videos):
            tex = _texture(rng, max(h0, w0) + 2 * margin)
            vel = rng.uniform(-1.5, 1.5, 2)
            off = np.round(np.arange(T)[:, None] * vel[None]).astype(int) + margin
            frames = np.stack([tex[oy:oy + h0, ox:ox + w0] for ox, oy in off])
            labels = np.zeros((T, h0, w0), np.uint8)
            for k in range(1, VOS_OBJECTS + 1):
                sprite = _texture(rng, 256)
                c0 = rng.uniform(0.3, 0.7, 2) * orig
                v = rng.uniform(-0.2, 0.2, 2) * orig / T
                ry, rx = rng.uniform(0.08, 0.18, 2) * orig
                for t in range(T):
                    cy, cx = c0 + t * v
                    inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
                    frames[t][inside] = sprite[(yy[inside] - int(cy)) % 256,
                                               (xx[inside] - int(cx)) % 256]
                    labels[t][inside] = k
            self.originals.append(frames)
            self.videos.append(resize_frames(frames, INPUT_SIZE))
            self.gt.append(labels)

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, i):
        return {"sequence": f"synthetic_{i}", "video": self.videos[i],
                "first_mask": self.gt[i][0], "original_shape": self.gt[i].shape[1:],
                "num_objects": int(self.gt[i][0].max())}

    def score_video(self, i, pred):
        from fgvc_tpu_torch.datasets.davis_vos import score_masks

        self.preds[i] = pred
        return score_masks(self.gt[i], pred)


def _agreement(a, b):
    return float(np.mean(np.concatenate([x.ravel() for x in a]) ==
                         np.concatenate([x.ravel() for x in b])))


def run_vos(ds, records, precision="highest"):
    """eval_vos banked (the banked entry, square) and with save_mem (the
    unbanked entry) on `ds` in one matmul_precision; returns {path:
    (J&F-Mean, label maps, peak device GB)}."""
    import dataclasses

    import torch

    from fgvc_tpu_torch.apis.test import build_tracker, eval_vos
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.core.metrics.iou import mean_iou
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    expect = sum(len(v) - 1 for v in ds.videos)
    n_frames = sum(len(v) for v in ds.videos)
    out = {}
    kernel_mode = k1.pallas_compute_dtype(precision)
    for path, save_mem in (("banked", False), ("save_mem", True)):
        mode = f"{precision} {path}"
        tracker = build_tracker(dataclasses.replace(DAVIS_TEST_CFG, save_mem=save_mem,
                                                    matmul_precision=precision),
                                seed=0, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        k1.reset_launches()
        t0 = time.time()
        res = eval_vos(tracker, ds)
        torch.cuda.synchronize()
        dt = time.time() - t0
        entry = "unbanked" if save_mem else "banked"
        check_launches(f"vos {mode}", precision, expect, entry)
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"vos {mode}: J&F (random weights) " + json.dumps(res))
        print(f"vos {mode}: {len(ds)} videos, {n_frames} frames at 480 x 880 in {dt:.2f} s "
              f"= {n_frames / dt:.2f} frames/s (model build excluded, scoring included); "
              f"peak device memory {peak:.2f} GB", flush=True)
        if not np.isfinite(res["J&F-Mean"]):
            raise AssertionError(f"vos {mode}: J&F-Mean is not finite: {res}")
        records[record_key("unbanked" if save_mem else "square", kernel_mode)]["launches"] = expect
        out[path] = (res["J&F-Mean"], [ds.preds[i] for i in range(len(ds))], peak)
        if path == "banked":
            iou = mean_iou(list(ds.preds[0]), list(ds.gt[0]), num_classes=VOS_OBJECTS + 1)
            print(f"vos {mode} video 0: mean_iou over its {len(ds.gt[0])} label maps (background "
                  f"and {VOS_OBJECTS} objects) mIoU {iou['mIoU']:.6f}, IoU "
                  f"{np.round(iou['IoU'], 6).tolist()}, beside J&F-Mean "
                  f"{res['J&F-Mean']:.6f} of both videos", flush=True)
            if not np.isfinite(iou["mIoU"]):
                raise AssertionError(f"vos {mode}: mIoU is not finite: {iou}")
            s = ds[0]
            by_kernel, wall_ms = device_ms_by_kernel(lambda: tracker.track_masks(
                s["video"], s["first_mask"], tuple(s["original_shape"]), s["num_objects"]))
            busy = sum(by_kernel.values())
            print(f"vos video 0 profiled (features + propagation + decode, {len(s['video'])} "
                  f"frames): wall {wall_ms:.1f} ms, device busy {busy:.1f} ms "
                  f"({100 * busy / wall_ms:.1f}%); top kernels: " + (_top(by_kernel) or "not measured"))
        del tracker
        torch.cuda.empty_cache()
    # float32 holds the two paths together; bf16 rounding of features that
    # were computed at batch 16 and at batch 1 may move a label near a tie
    limit = MASK_AGREE if precision == "highest" else None
    agree = _agreement(out["banked"][1], out["save_mem"][1])
    print(f"vos {precision} banked vs save_mem label maps: {100 * agree:.5f}% of pixels "
          f"agree (limit {'none' if limit is None else f'{100 * limit}%'})", flush=True)
    if limit is not None and not agree >= limit:
        raise AssertionError(f"banked and save_mem masks agree on {agree} < {limit}")
    return out


def run_vos_plain(ds, n_frames=8, precision="highest", agree_limit=PLAIN_MASK_AGREE,
                  jf_tol=JF_TOL):
    """Video 0 cut to n_frames, banked and save_mem, through the kernels
    and through the plain versions on the card, in one matmul_precision;
    label maps agree on >= agree_limit of pixels and J&F-Mean within jf_tol
    (where given)."""
    import dataclasses

    import torch

    import fgvc_tpu_torch.models.tracker as tracker_mod
    from fgvc_tpu_torch.apis.test import build_tracker
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.core.metrics.vos import aggregate_jf
    from fgvc_tpu_torch.datasets.davis_vos import score_masks
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    s = ds[0]
    video, gt = s["video"][:n_frames], ds.gt[0][:n_frames]
    args = (video, s["first_mask"], tuple(s["original_shape"]), s["num_objects"])
    for save_mem in (False, True):
        tracker = build_tracker(dataclasses.replace(DAVIS_TEST_CFG, save_mem=save_mem,
                                                    matmul_precision=precision),
                                seed=0, device="cuda")
        torch.cuda.synchronize()
        t0 = time.time()
        out_k = tracker.track_masks(*args)
        t_k = time.time() - t0
        tracker_mod.topk_attention_banked = k1.topk_attention_banked_plain
        tracker_mod.topk_attention = k1.topk_attention_plain
        try:
            t0 = time.time()
            out_p = tracker.track_masks(*args)
            t_p = time.time() - t0
        finally:
            tracker_mod.topk_attention_banked = k1.topk_attention_banked
            tracker_mod.topk_attention = k1.topk_attention
        agree = _agreement([out_k], [out_p])
        jf = [aggregate_jf([score_masks(gt, o)])["J&F-Mean"] for o in (out_k, out_p)]
        mode = f"{precision} {'save_mem' if save_mem else 'banked'}"
        print(f"vos_plain {mode} ({n_frames} frames): kernel {1e3 * t_k:.1f} ms, plain "
              f"{1e3 * t_p:.1f} ms; label maps agree on {100 * agree:.5f}% of pixels; "
              f"J&F-Mean {jf[0]:.6f} vs {jf[1]:.6f} (|diff| {abs(jf[0] - jf[1]):.3e})", flush=True)
        if not agree >= agree_limit:
            raise AssertionError(f"vos_plain {mode}: masks agree on {agree} < {agree_limit}")
        if jf_tol is not None and not abs(jf[0] - jf[1]) <= jf_tol:
            raise AssertionError(f"vos_plain {mode}: J&F-Mean differs by {abs(jf[0] - jf[1])}")
        del tracker
        torch.cuda.empty_cache()


def run_modes_tapvid(data_root, records):
    """run_task('davis') in each matmul_precision on the same pickles and
    weights; 'high' and 'default' held to 'highest'."""
    import dataclasses

    import torch

    from fgvc_tpu_torch.apis.test import build_tracker, run_task
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ds = TapVidDataset(data_root)
    expect = frames_propagated(ds)
    n_frames = sum(len(ds[i]["video"]) for i in range(len(ds)))
    delta_d, traj = {}, {}
    for precision in PRECISIONS:
        cfg = dataclasses.replace(DAVIS_TEST_CFG, matmul_precision=precision)
        k1.reset_launches()
        t0 = time.time()
        metrics = run_task("davis", data_root, test_cfg=cfg, device="cuda", seed=0)
        torch.cuda.synchronize()
        dt = time.time() - t0
        check_launches(f"modes davis {precision}", precision, expect, "banked")
        check_metrics(metrics)
        records[record_key("circle", k1.pallas_compute_dtype(precision))]["launches"] = expect
        delta_d[precision] = metrics["average_pts_within_thresh"]
        print(f"modes davis {precision}: <D {delta_d[precision]:.4f}, AJ "
              f"{metrics['average_jaccard']:.4f}; {n_frames} frames in {dt:.2f} s = "
              f"{n_frames / dt:.2f} frames/s (model build and data reading included)", flush=True)
        # the trajectories, after the counts were read
        tracker = build_tracker(cfg, seed=0, device="cuda")
        traj[precision] = np.concatenate([
            tracker.track_points(ds[i]["video"], ds[i]["query_points"])["trajectories"].ravel()
            for i in range(len(ds))])
        del tracker
    for precision in ("high", "default"):
        diff = np.abs(traj[precision] - traj["highest"])
        med, dd = float(np.median(diff)), abs(delta_d[precision] - delta_d["highest"])
        print(f"modes davis {precision} vs highest: trajectories median |diff| {med:.3e} px, "
              f"max {diff.max():.3e} px; <D {delta_d[precision]:.4f} vs "
              f"{delta_d['highest']:.4f} (|diff| {dd:.4f}, limit {MODE_DELTA_D[precision]})",
              flush=True)
        if precision == "high" and not med <= MODE_TRAJ_TOL_PX:
            raise AssertionError(f"'high' trajectories: median |diff| {med} > {MODE_TRAJ_TOL_PX}")
        if not dd <= MODE_DELTA_D[precision]:
            raise AssertionError(f"{precision!r} <D differs by {dd} > {MODE_DELTA_D[precision]}")


def run_modes_vos(records):
    """eval_vos on one synthetic video in each matmul_precision, banked and
    save_mem, against 'highest'; then that video's first 8 frames through
    the kernels and the plain versions in 'high' and 'default'."""
    ds = SyntheticDavis(n_videos=1)
    runs = {precision: run_vos(ds, records, precision) for precision in PRECISIONS}
    for precision in ("high", "default"):
        for path in ("banked", "save_mem"):
            jf, preds, peak = runs[precision][path]
            jf0, preds0, peak0 = runs["highest"][path]
            print(f"modes vos {precision} {path} vs highest: J&F-Mean {jf:.6f} vs {jf0:.6f} "
                  f"(|diff| {abs(jf - jf0):.3e}, limit {MODE_JF_TOL}); label maps agree on "
                  f"{100 * _agreement(preds, preds0):.4f}% of pixels; peak device memory "
                  f"{peak:.2f} GB vs {peak0:.2f} GB ({peak - peak0:+.2f} GB)", flush=True)
            if not abs(jf - jf0) <= MODE_JF_TOL:
                raise AssertionError(f"vos {precision} {path}: J&F-Mean differs by {abs(jf - jf0)}")
    for precision in ("high", "default"):
        run_vos_plain(ds, precision=precision, agree_limit=MASK_AGREE, jf_tol=None)


def _peak_gb_of(fn):
    """(fn(), peak device GB allocated while it ran)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 1e9


def _trajectories(tracker, ds):
    return np.concatenate([tracker.track_points(ds[i]["video"], ds[i]["query_points"])
                           ["trajectories"].ravel() for i in range(len(ds))])


def run_sp_tapvid(data_root, record, card, e2e_metrics=None):
    """run_task('davis', spatial_devices=[card] * 2) on the e2e pickles:
    only K4 launches, two per frame propagated; <D equal to the unsharded
    run's; trajectories of the row-block tracker equal to the unsharded
    tracker's; with two cards or more, the same on two distinct cards."""
    import torch

    from fgvc_tpu_torch.apis.test import build_tracker, run_task
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ds = TapVidDataset(data_root)
    expect = frames_propagated(ds)
    if e2e_metrics is None:
        e2e_metrics = run_task("davis", data_root, device=card, seed=0)
    S = 2
    k1.reset_launches()
    t0 = time.time()
    metrics, peak = _peak_gb_of(lambda: run_task("davis", data_root, seed=0,
                                                 spatial_devices=[card] * S))
    dt = time.time() - t0
    check_launches(f"sp davis S={S}", "highest", S * expect, "row_block")
    check_metrics(metrics)
    record["launches"] = S * expect
    d0, d1 = e2e_metrics["average_pts_within_thresh"], metrics["average_pts_within_thresh"]
    print(f"sp davis S={S} on one card: <D {d1:.6f} vs unsharded {d0:.6f}; {dt:.2f} s "
          f"(model build and data reading included); peak device memory {peak:.2f} GB",
          flush=True)
    if d1 != d0:
        raise AssertionError(f"sp davis: <D {d1} differs from the unsharded {d0}")
    single, peak0 = _peak_gb_of(lambda: _trajectories(build_tracker(seed=0, device=card), ds))
    sp, peak1 = _peak_gb_of(lambda: _trajectories(
        build_tracker(seed=0, spatial_devices=[card] * S), ds))
    diff = np.abs(sp - single)
    print(f"sp davis S={S} trajectories vs unsharded: max |diff| {diff.max():.3e} px "
          f"(limit {SP_TRAJ_TOL_PX}); peak device memory over both videos {peak1:.2f} GB vs "
          f"{peak0:.2f} GB unsharded", flush=True)
    if not diff.max() <= SP_TRAJ_TOL_PX:
        raise AssertionError(f"sp davis: trajectories differ by {diff.max()} px")
    if torch.cuda.device_count() < 2:
        print("sp davis on distinct cards: not run (this machine has one card)", flush=True)
        return
    k1.reset_launches()
    multi = _trajectories(build_tracker(seed=0, spatial_devices=S), ds)
    check_launches(f"sp davis S={S} on {S} cards", "highest", S * expect, "row_block")
    diff = np.abs(multi - single)
    print(f"sp davis S={S} on {S} distinct cards: trajectories vs unsharded median |diff| "
          f"{np.median(diff):.3e} px, max {diff.max():.3e} px (median limit {TRAJ_TOL_PX})",
          flush=True)
    if not np.median(diff) <= TRAJ_TOL_PX:
        raise AssertionError(f"sp davis on {S} cards: median |diff| {np.median(diff)} px")


def run_sp_vos(record, card):
    """One synthetic VOS video through eval_vos, unsharded and on `card`
    listed S times: banked at S = 2 and save_mem at S = 4 in 'highest',
    save_mem at S = 2 in 'default'; label maps 100% equal, only K4 launches
    in the row-block runs (S per frame propagated)."""
    import dataclasses

    import torch

    from fgvc_tpu_torch.apis.test import build_tracker, eval_vos
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ds = SyntheticDavis(n_videos=1)
    frames = len(ds.videos[0]) - 1
    record["launches"] = 0
    for precision, save_mem, S in (("highest", False, 2), ("highest", True, 4),
                                   ("default", True, 2)):
        cfg = dataclasses.replace(DAVIS_TEST_CFG, save_mem=save_mem, matmul_precision=precision)
        path = f"{precision} {'save_mem' if save_mem else 'banked'}"
        runs = {}
        for spatial in (None, [card] * S):
            tracker = build_tracker(cfg, seed=0, device=card, spatial_devices=spatial)
            k1.reset_launches()
            t0 = time.time()
            res, peak = _peak_gb_of(lambda: eval_vos(tracker, ds))
            dt = time.time() - t0
            if spatial is None:
                check_launches(f"sp vos {path} unsharded", precision, frames,
                               "unbanked" if save_mem else "banked")
            else:
                check_launches(f"sp vos {path} S={S}", precision, S * frames, "row_block")
                if precision == "highest":
                    record["launches"] += S * frames
            runs[spatial is None] = (res["J&F-Mean"], ds.preds[0], peak, dt)
            del tracker
            torch.cuda.empty_cache()
        (jf0, pred0, peak0, dt0), (jf1, pred1, peak1, dt1) = runs[True], runs[False]
        agree = _agreement([pred1], [pred0])
        print(f"sp vos {path} S={S} vs unsharded: label maps agree on {100 * agree:.5f}% of "
              f"pixels (must be 100%); J&F-Mean {jf1:.6f} vs {jf0:.6f}; {dt1:.2f} s vs "
              f"{dt0:.2f} s (scoring included); peak device memory {peak1:.2f} GB vs "
              f"{peak0:.2f} GB ({peak1 - peak0:+.2f} GB)", flush=True)
        if agree != 1.0:
            raise AssertionError(f"sp vos {path} S={S}: label maps differ from the unsharded run")


def check_cut(label, out, ref, passes, near_fn):
    """K5 cut `passes` against its plain version; returns max |diff|.  Cut
    'a': masked affinities equal bit for bit, live ones within AFF_RTOL *
    max|a|.  Cut 'ab': on every row but near-tie rows (near_fn(), asked only
    where a row differs; at most NEAR_TIE_SHARE of the rows) n_above and
    cnt_at equal, thresh, mmax and frac within KERNEL_TOL, z within Z_RTOL
    relative; the columns past the six statistics 0."""
    import torch

    neg = -1e30
    if passes == "a":
        masked = ref <= neg / 2
        if not torch.equal(out <= neg / 2, masked) or not torch.equal(out[masked], ref[masked]):
            raise AssertionError(f"{label}: masked affinities differ from the plain version")
        live = (out[~masked] - ref[~masked]).abs()
        err = live.max().item() if live.numel() else 0.0
        limit = AFF_RTOL * (ref[~masked].abs().max().item() if live.numel() else 0.0)
        print(f"{label}: {live.numel()} live and {int(masked.sum())} masked columns; masked "
              f"equal; live max |kernel - plain| = {err:.3e} (limit {limit:.3e})", flush=True)
        if not err <= limit:
            raise AssertionError(f"{label}: live affinities disagree with the plain version")
        return err
    n = min(out.shape[-1], 6)
    d = (out - ref).abs()
    bad = (d[..., [0, 1, 3]] > KERNEL_TOL).any(-1)  # thresh, mmax, frac
    bad |= d[..., 2] > Z_RTOL * ref[..., 2].abs()
    bad |= (out[..., 4:n] != ref[..., 4:n]).any(-1)  # n_above, cnt_at
    n_bad, rows = int(bad.sum()), bad.numel()
    far = int((bad & ~near_fn().to(bad.device)).sum()) if n_bad else 0
    err = d.max().item()
    print(f"{label}: max |kernel - plain| = {err:.3e}; {n_bad} of {rows} rows differ beyond "
          f"counts equal, z within {Z_RTOL} relative, the rest within {KERNEL_TOL} "
          f"({n_bad - far} near-tie rows, {far} others)", flush=True)
    if far or n_bad > NEAR_TIE_SHARE * rows or out[..., n:].any().item():
        raise AssertionError(f"{label}: kernel disagrees with plain version")
    return err


def run_passes(records):
    """K5 through the pass-breakdown tool, one compute mode at a time with
    the counts reset before and read after; then each cut against its plain
    version on the tool's inputs, timed and bounded."""
    import torch

    from fgvc_tpu_torch.bench import pass_breakdown as pb
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1
    from fgvc_tpu_torch.utils.profiler import events_ms

    reps = 20
    split = {}
    for mode in k1.COMPUTE_DTYPES:
        k1.reset_launches()
        res = pb.run("cuda", reps=reps, modes=(mode,))
        torch.cuda.synchronize()
        n = reps + 2  # warm-up, reps, one profiled call
        got = (dict(k1.cut_launches), k1.unbanked_launches, dict(k1.mode_launches))
        want = ({"a": n, "ab": n}, n, {m: n if m == mode else 0 for m in k1.mode_launches})
        print(f"passes '{mode}': cut launches {got[0]}, unbanked {got[1]}, by mode {got[2]} "
              f"(expected {n} each)", flush=True)
        if got != want:
            raise AssertionError(f"passes '{mode}': launches {got}, expected {want}")
        split[mode] = res["ms"][mode]
        for cut, kernels in res["device_ms_by_kernel"][mode].items():
            print(f"passes '{mode}' cut '{cut}' device ms by CUDA kernel (torch.profiler): "
                  + (_top(kernels) or "not measured"), flush=True)
        for cut in ("a", "ab"):
            by_kernel = res["device_ms_by_kernel"][mode][cut]
            ab = cut == "ab"  # cut 'a' runs no select_kernel
            records[f"K5_{cut}_{_TAG[mode]}"].update(
                launches=n, ms=split[mode][cut], affinity_device_ms=affinity_ms(by_kernel, 1),
                select_device_ms=affinity_ms(by_kernel, 1, "select_kernel") if ab else None,
                select_bound_ms=select_bound(H, W, CV, values=False) if ab else None)
    print("per-pass split (ms per call; A = t('a'), B = t('ab') - t('a'), C = t('abc') - t('ab')): "
          + json.dumps(split), flush=True)

    inputs = pb.make_inputs(device="cuda")
    q, k, v = inputs
    h, w = q.shape[:2]
    # query and keys (float32 at the entry in every mode), the cut's output
    nbytes = 4.0 * (h * w * C + SLOTS * h * w * C) + 4.0 * h * w * CV
    for mode in k1.COMPUTE_DTYPES:
        bound_ms, bound_by, flops = attention_bound(h, w, "circle", [True] * SLOTS, nbytes, mode)
        for cut in ("a", "ab"):
            record = records[f"K5_{cut}_{_TAG[mode]}"]
            label = f"K5 cut '{cut}' '{mode}'"
            kw = dict(radius=pb.RADIUS, temperature=pb.TEMPERATURE, topk=pb.TOPK, tile=pb.TILE,
                      compute_dtype=mode, debug_passes=cut)
            out = pb.call(inputs, mode, cut)
            ref = k1.topk_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            near_kw = {x: y for x, y in kw.items() if x != "debug_passes"}
            err = check_cut(label, out, ref, cut,
                            lambda: k1.near_tie_rows_plain_unbanked(q, k, v, stats=True,
                                                                    **near_kw))
            del out, ref
            plain_ms = events_ms(lambda: k1.topk_attention_plain(q, k, v, **kw), 3)
            print(f"{label}: kernel {record['ms']:.3f} ms, plain {plain_ms:.3f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP live)", flush=True)
            record.update(max_abs_err=err, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        # cut 'a' at every column of slot 0's window, live ones included
        full = torch.zeros((v.shape[0], h, w, FULL_WINDOW_CV), device=v.device)
        kw = dict(radius=pb.RADIUS, temperature=pb.TEMPERATURE, topk=pb.TOPK, tile=pb.TILE,
                  compute_dtype=mode, debug_passes="a")
        err = check_cut(f"K5 cut 'a' '{mode}' Cv={FULL_WINDOW_CV}",
                        k1.topk_attention(q, k, full, **kw),
                        k1.topk_attention_plain(q, k, full, **kw), "a", None)
        record = records[f"K5_a_{_TAG[mode]}"]
        record["max_abs_err"] = max(record["max_abs_err"], err)
        del full
    del inputs, q, k, v
    torch.cuda.empty_cache()


def overlap_bound(kind):
    """Least time for one K6 call: the products (three TF32 products each,
    on the tensor cores) and the rounds (4 SIMT operations an element) run
    side by side, so the larger of the two, or the bytes (q, k, out and the
    scratch writes) over the HBM rate."""
    from fgvc_tpu_torch.ops.cuda import mxu_vpu_overlap as k6

    t_mma = 3 * 2.0 * k6.S * k6.C * k6.T * k6.FK / PEAK_TF32_FLOPS if kind != "vpu" else 0.0
    cols, rounds = {"mxu": (0, 0), "vpu": (k6.T * k6.FK, k6.R), "mixed": (k6.FK, 2 * k6.T)}[kind]
    t_simt = 4.0 * k6.S * cols * rounds / PEAK_SIMT_OPS
    written = k6.FK if kind == "vpu" else k6.T * k6.FK
    nbytes = 4.0 * (k6.S * k6.C + k6.S * 128 + k6.S * written
                    + (0 if kind == "vpu" else k6.T * k6.FK * k6.C))
    t_ops, t_bytes = max(t_mma, t_simt), nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def run_overlap(records):
    """K6 through the overlap tool with the counts reset before and read
    after; then each kind against its plain version, timed and bounded."""
    import torch

    from fgvc_tpu_torch.bench import mxu_vpu_overlap as bench
    from fgvc_tpu_torch.ops.cuda import mxu_vpu_overlap as k6
    from fgvc_tpu_torch.utils.profiler import events_ms

    k6.reset_launches()
    res = bench.run("cuda")
    torch.cuda.synchronize()
    n = res["iters"] + 1  # warm-up and the timed launches
    got = dict(k6.launches)
    print(f"overlap: launches {got} (expected {n} each)", flush=True)
    if got != dict.fromkeys(k6.KINDS, n):
        raise AssertionError(f"overlap: launches {got}, expected {n} each")
    q, k = bench.make_inputs("cuda")
    out = {kind: k6.overlap(kind, q, k) for kind in k6.KINDS}
    ref = {kind: k6.overlap_plain(kind, q, k) for kind in k6.KINDS}
    torch.cuda.synchronize()
    errs = {kind: (out[kind] - ref[kind]).abs().max().item() for kind in k6.KINDS}
    counts = [torch.round(r["mixed"] - r["mxu"]) for r in (out, ref)]
    frac = ((out["mixed"] - out["mxu"]) - counts[0]).abs().max().item()
    print(f"overlap: max |kernel - plain| mxu {errs['mxu']:.3e} (tolerance {MXU_TOL}), "
          f"mixed {errs['mixed']:.3e}, vpu {errs['vpu']:.3e}; mixed - mxu counts "
          f"{counts[0].min().item():.0f}..{counts[0].max().item():.0f} (plain "
          f"{counts[1].min().item():.0f}..{counts[1].max().item():.0f}), off an integer by "
          f"{frac:.2e}; vpu rows {out['vpu'].min().item():.0f}..{out['vpu'].max().item():.0f} "
          f"(must be {10 * k6.FK})", flush=True)
    if not errs["mxu"] <= MXU_TOL or not frac <= 1e-3 or not torch.equal(counts[0], counts[1]):
        raise AssertionError("overlap: 'mxu' or 'mixed' disagrees with the plain version")
    if not torch.equal(out["vpu"], torch.full_like(out["vpu"], 10.0 * k6.FK)):
        raise AssertionError("overlap: 'vpu' is not 10 * FK on every row")
    for kind in k6.KINDS:
        plain_ms = events_ms(lambda: k6.overlap_plain(kind, q, k), 3)
        bound_ms, bound_by = overlap_bound(kind)
        print(f"overlap {kind}: kernel {res['ms'][kind]:.4f} ms, plain {plain_ms:.3f} ms, "
              f"bound {1e3 * bound_ms:.2f} us ({bound_by})"
              + (f", torch.matmul {res['matmul_ms']:.4f} ms" if kind == "mxu" else ""),
              flush=True)
        records[f"K6_{kind}"].update(
            launches=n, ms=res["ms"][kind], plain_ms=plain_ms, max_abs_err=errs[kind],
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=res["matmul_ms"] if kind == "mxu" else None)


def make_raft_pth(path, seed=0):
    """Seeded RAFT weights at the official width (fnet and cnet 256
    channels, batch-normed cnet, 4 levels, radius 4) saved under the
    official names, ``module.`` prefixed as the released files are."""
    import torch

    from fgvc_tpu_torch.models.raft import RAFT
    from fgvc_tpu_torch.models.resnet import init_flax_like

    model = init_flax_like(RAFT(cnet_norm="batch"), torch.Generator().manual_seed(seed))
    torch.save({"module." + k: v for k, v in model.state_dict().items()}, path)
    return path


def _score(ds, s, out):
    return ds.evaluate([{
        "trajectories_gt": s["trajectories"], "visibilities_gt": s["visibilities"],
        "trajectories_pred": out["trajectories"], "visibilities_pred": out["visibilities"],
        "query_points": s["query_points"],
    }])


def check_no_launches(label):
    """No kernel of fgvc_tpu_torch launched since the last reset."""
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    got = {"banked": k1.launches, "unbanked": k1.unbanked_launches,
           "row_block": k1.row_block_launches, "cut": sum(k1.cut_launches.values())}
    print(f"{label}: attention kernel launches {got} (expected none)", flush=True)
    if any(got.values()):
        raise AssertionError(f"{label}: the attention kernel launched: {got}")


def run_raft(data_root):
    """The RAFT baseline (--model raft): (a) one 256 x 256 frame pair on the
    card against the same model on the CPU; (b) run_task('davis',
    model='raft') on the e2e pickles, no attention kernel launched, and
    video 0's flows, chaining, wall time, peak and busy share; (c) video 0's
    trajectories on the card against the port on the CPU."""
    import copy

    import torch

    from fgvc_tpu_torch.apis.test import build_raft_tracker, run_task
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.models.raft import PAIR_CHUNK, chain_flows_track
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1
    from fgvc_tpu_torch.utils.profiler import events_ms

    pth = make_raft_pth(os.path.join(data_root, "raft_seeded.pth"))
    tracker = build_raft_tracker(pth, device="cuda")
    ds = TapVidDataset(data_root)
    s = ds[0]
    T = len(s["video"])

    # (a) one pair at batch 1, card against CPU
    pair = torch.from_numpy(s["video"][:2]).permute(0, 3, 1, 2).float() / 127.5 - 1.0
    model = tracker.model
    im1, im2 = pair[:1].cuda(), pair[1:].cuda()
    with torch.no_grad():
        flow = model(im1, im2)[-1]
        pair_ms = events_ms(lambda: model(im1, im2), 3)
        t0 = time.time()
        cpu_flow = copy.deepcopy(model).cpu()(pair[:1], pair[1:])[-1]
        t_cpu = time.time() - t0
    diff = (flow.cpu() - cpu_flow).abs()
    med, mx = float(diff.median()), float(diff.max())
    print(f"raft (a): one 256x256 pair at batch 1, {model.iters} iterations: {pair_ms:.3f} ms on "
          f"the card (CUDA events), {t_cpu:.2f} s on the CPU; final flow card vs CPU median "
          f"|diff| {med:.3e} px, max {mx:.3e} px (limits {RAFT_FLOW_MEDIAN_PX}, "
          f"{RAFT_FLOW_MAX_PX}); |flow| up to {float(cpu_flow.abs().max()):.2f} px", flush=True)
    if not (med <= RAFT_FLOW_MEDIAN_PX and mx <= RAFT_FLOW_MAX_PX):
        raise AssertionError(f"raft (a): card vs CPU flow median {med}, max {mx} px")

    # (b) the CLI's path on both videos, then video 0 measured
    k1.reset_launches()
    t0 = time.time()
    metrics = run_task("davis", data_root, checkpoint=pth, device="cuda", model="raft")
    torch.cuda.synchronize()
    dt = time.time() - t0
    check_no_launches("raft run_task")
    check_metrics(metrics)
    print(f"raft (b): run_task('davis', model='raft') {len(ds)} videos in {dt:.2f} s (model "
          "build and data reading included); metrics " + json.dumps(
              {k: metrics[k] for k in ("average_pts_within_thresh", "average_jaccard",
                                       "occlusion_accuracy", "pts_within_1", "pts_within_16")}),
          flush=True)
    n_flows = 2 * (T - 1)
    flows = []
    flows_ms = events_ms(lambda: flows.append(tracker.flows(s["video"])), 1)
    fwd, bwd = (f.permute(0, 2, 3, 1).cpu().numpy() for f in flows[0])
    t0 = time.time()
    chain_flows_track(fwd, bwd, s["query_points"])
    chain_ms = 1e3 * (time.time() - t0)
    t0 = time.time()
    out, peak = _peak_gb_of(lambda: tracker.track_points(s["video"], s["query_points"]))
    wall_ms = 1e3 * (time.time() - t0)
    by_kernel, prof_ms = device_ms_by_kernel(
        lambda: tracker.track_points(s["video"], s["query_points"]))
    busy = sum(by_kernel.values())
    print(f"raft (b) video 0 ({T} frames, {n_flows} flows): flows {flows_ms:.1f} ms on the "
          f"card = {flows_ms / n_flows:.3f} ms a flow (CUDA events; encoders once a frame, "
          f"{PAIR_CHUNK} pairs a call); chain_flows_track {chain_ms:.2f} ms on the host; "
          f"track_points wall {wall_ms:.1f} ms; peak device memory {peak:.3f} GB", flush=True)
    if busy:
        print(f"raft (b) video 0 profiled: wall {prof_ms:.1f} ms, device busy {busy:.1f} ms "
              f"({100 * busy / prof_ms:.1f}%); top kernels: " + _top(by_kernel, 8), flush=True)
    else:
        print("raft (b) video 0 profile: device time not measured by torch.profiler")

    # (c) video 0, card against CPU
    cpu_tracker = build_raft_tracker(pth, device="cpu")
    t0 = time.time()
    ref = cpu_tracker.track_points(s["video"], s["query_points"])
    t_cpu = time.time() - t0
    diff = np.abs(out["trajectories"] - ref["trajectories"])
    med = float(np.median(diff))
    d_card = _score(ds, s, out)["average_pts_within_thresh"]
    d_cpu = _score(ds, s, ref)["average_pts_within_thresh"]
    print(f"raft (c) video 0 card vs CPU ({t_cpu:.1f} s on the CPU): trajectories median |diff| "
          f"{med:.3e} px, max {diff.max():.3e} px (median limit {RAFT_TRAJ_MEDIAN_PX}); "
          f"visibilities equal on {100 * np.mean(out['visibilities'] == ref['visibilities']):.3f}%"
          f"; <D {d_card:.4f} vs {d_cpu:.4f}", flush=True)
    if not med <= RAFT_TRAJ_MEDIAN_PX:
        raise AssertionError(f"raft (c): median trajectory difference {med} px")
    if not abs(d_card - d_cpu) <= DELTA_D_TOL:
        raise AssertionError(f"raft (c): <D differs by {abs(d_card - d_cpu)}")


def _tracks(tracker, ds):
    return [tracker.track_points(ds[i]["video"], ds[i]["query_points"]) for i in range(len(ds))]


def run_decode(data_root):
    """visibility_mode 'heatmap' with decode_impl 'upsample' and 'coarse'
    through run_task('davis') on the e2e pickles (K1, one launch per frame
    propagated); 'upsample' trajectories equal the default tracker's; video
    0 through K1 and the plain version; the card listed twice (K4) against
    the unsharded run."""
    import dataclasses

    import torch

    from fgvc_tpu_torch.apis.test import build_tracker, run_task
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ds = TapVidDataset(data_root)
    expect = frames_propagated(ds)
    s = ds[0]
    cfgs = {d: dataclasses.replace(DAVIS_TEST_CFG, visibility_mode="heatmap", decode_impl=d)
            for d in ("upsample", "coarse")}
    base = _tracks(build_tracker(seed=0, device="cuda"), ds)
    for d, cfg in cfgs.items():
        k1.reset_launches()
        metrics = run_task("davis", data_root, test_cfg=cfg, device="cuda", seed=0)
        torch.cuda.synchronize()
        check_launches(f"decode {d}", "highest", expect, "banked")
        check_metrics(metrics)
        tracker = build_tracker(cfg, seed=0, device="cuda")
        outs = _tracks(tracker, ds)
        vis = np.concatenate([o["visibilities"].ravel() for o in outs])
        t0 = time.time()
        tracker.track_points(s["video"], s["query_points"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)
        print(f"decode {d} + heatmap visibility (threshold {cfg.visibility_threshold}): visible "
              f"{100 * vis.mean():.2f}% of predictions; AJ {metrics['average_jaccard']:.4f}, "
              f"OA {metrics['occlusion_accuracy']:.4f}, <D "
              f"{metrics['average_pts_within_thresh']:.4f}; video 0 track_points wall "
              f"{wall_ms:.1f} ms", flush=True)
        if d == "upsample":
            same = all(np.array_equal(o["trajectories"], b["trajectories"])
                       for o, b in zip(outs, base))
            print(f"decode upsample trajectories equal the default tracker's bit for bit: {same}",
                  flush=True)
            if not same:
                raise AssertionError("decode upsample: trajectories differ from e2e's")
            plain = _plain_propagation(lambda: tracker.track_points(s["video"], s["query_points"]))
            diff = np.abs(outs[0]["trajectories"] - plain["trajectories"])
            agree = float(np.mean(outs[0]["visibilities"] == plain["visibilities"]))
            d0 = _score(ds, s, outs[0])["average_pts_within_thresh"]
            d1 = _score(ds, s, plain)["average_pts_within_thresh"]
            print(f"decode upsample video 0 K1 vs plain: trajectories median |diff| "
                  f"{np.median(diff):.3e} px, max {diff.max():.3e}; visibilities agree on "
                  f"{100 * agree:.3f}% (limit {100 * VIS_AGREE}); <D {d0:.4f} vs {d1:.4f}",
                  flush=True)
            if not (np.median(diff) <= TRAJ_TOL_PX and agree >= VIS_AGREE
                    and abs(d0 - d1) <= DELTA_D_TOL):
                raise AssertionError("decode: K1 against plain out of its limits")
        card = torch.device("cuda", torch.cuda.current_device())
        k1.reset_launches()
        sp = build_tracker(cfg, seed=0, spatial_devices=[card] * 2).track_points(
            s["video"], s["query_points"])
        check_launches(f"decode {d} S=2", "highest", 2 * frames_propagated([s]), "row_block")
        same = (np.array_equal(sp["trajectories"], outs[0]["trajectories"])
                and np.array_equal(sp["visibilities"], outs[0]["visibilities"]))
        print(f"decode {d} S=2 on one card: trajectories and visibilities equal the unsharded "
              f"run's bit for bit: {same}", flush=True)
        if not same:
            raise AssertionError(f"decode {d}: row blocks differ from the unsharded run")


def run_profile(data_root):
    """The port's CLI with --profile on one e2e pickle: the Chrome trace
    holds the harness's spans and both CUDA kernels of K1."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as logdir:
        cmd = [sys.executable, "-m", "fgvc_tpu_torch.cli.test", "--task", "davis",
               "--data-root", data_root, "--max-videos", "1", "--output-dir",
               os.path.join(logdir, "eval"), "--profile", logdir]
        t0 = time.time()
        subprocess.run(cmd, cwd=ROOT, check=True, timeout=900, stdout=subprocess.DEVNULL)
        path = os.path.join(logdir, "trace.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        names = {e.get("name", "") for e in events}
        found = {want: any(want in name for name in names)
                 for want in ("propagate[0]", "collect[0]", "affinity_kernel", "select_kernel")}
        print(f"profile: cli.test --profile in {time.time() - t0:.1f} s; {path}: "
              f"{os.path.getsize(path) / 1e6:.1f} MB, {len(events)} events; found {found}",
              flush=True)
        if not all(found.values()):
            raise AssertionError(f"profile: the trace lacks {[k for k, v in found.items() if not v]}")



# phase serve: the client's VOS resolution, and the labels of a 3-object mask
SERVE_ORIG = (480, 854)
SERVE_CV = VOS_OBJECTS + 1
# phase export: the value channels of the exported step
EXPORT_CV = 8


def _post_npz(port, path, **arrays):
    """POST an npz body to the server on `port`: (reply, client wall s,
    request MB, the client's JSON decode s)."""
    import io
    import urllib.request

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    body = buf.getvalue()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST")
    t0 = time.time()
    with urllib.request.urlopen(req, timeout=600) as r:
        raw = r.read()
    t1 = time.time()
    reply = json.loads(raw)
    t2 = time.time()
    return reply, t2 - t0, len(body) / 1e6, t2 - t1


def _http_status(port, path, method="GET", **arrays):
    """The HTTP status of a request (an error status included)."""
    import io
    import urllib.error
    import urllib.request

    data = None
    if method == "POST":
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        data = buf.getvalue()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _same_track(label, reply, traj, vis):
    """A /v1/track reply against the direct call's (T, P, 2) float64
    trajectories and (T, P) visibilities, bit for bit."""
    got = np.asarray(reply["trajectories"])
    got_vis = np.asarray(reply["visibilities"])
    if got.shape != traj.shape or not np.array_equal(got, traj) \
            or not np.array_equal(got_vis, vis):
        diff = np.abs(got - traj).max() if got.shape == traj.shape else got.shape
        raise AssertionError(f"{label}: the reply differs from the direct call ({diff})")


def run_serve(data_root, records):
    """Phase serve: fgvc_tpu_torch.cli.serve's server on an ephemeral port
    over the tracker serve_tracker builds (the davis preset at 256 x 256,
    heatmap visibility, seeded ResNet-18-d1 at full width, warmed), then
    (a)-(e) over HTTP; each request's launches counted from 0."""
    import threading

    import torch

    from fgvc_tpu_torch.cli import serve
    from fgvc_tpu_torch.datasets.image_io import resize_frames
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    t_phase = time.time()
    tracker, summary = serve.serve_tracker(serve.build_parser().parse_args(["--port", "0"]))
    if tracker.cfg.visibility_mode != "heatmap" or tracker.cfg.input_size != (256, 256):
        raise AssertionError(f"serve: unexpected serving config {tracker.cfg}")
    server, stats = serve.make_server(tracker, 0, summary)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    print(f"serve: tracker built and warmed in {time.time() - t_phase:.1f} s, {summary}, "
          f"on 127.0.0.1:{port}", flush=True)

    def request(label, path, launches, **arrays):
        k1.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reply, wall, mb, decode = _post_npz(port, path, **arrays)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        check_launches(f"serve {label}", "highest", launches, "banked")
        n = len(arrays["video"])
        print(f"serve {label}: {n} frames, request {mb:.1f} MB; server ms {reply['ms']:.2f} "
              f"= {1e3 * n / reply['ms']:.1f} frames/s; client wall {1e3 * wall:.1f} ms "
              f"(reply JSON decode {1e3 * decode:.1f} ms); peak device memory {peak:.2f} GB",
              flush=True)
        return reply

    try:
        s = TapVidDataset(data_root)[0]
        video, pts = s["video"], s["query_points"]
        T = len(video)
        expect = sum(T - int(t) - 1 for t in np.unique(pts[:, 0].astype(int)))
        # (a) e2e video 0 at the model's size
        a = request("(a) /v1/track 256x256", "/v1/track", expect, video=video, query_points=pts)
        direct = tracker.track_points(video, pts)
        _same_track("serve (a)", a, direct["trajectories"].astype(np.float64),
                    direct["visibilities"])
        # (b) the same video at 480 x 854: resized on the host, points scaled
        h0, w0 = SERVE_ORIG
        big = resize_frames(video, SERVE_ORIG)
        pts_big = pts.copy()
        pts_big[:, 1] *= w0 / 256
        pts_big[:, 2] *= h0 / 256
        b = request("(b) /v1/track 480x854", "/v1/track", expect, video=big,
                    query_points=pts_big)
        spts = pts_big.copy()
        spts[:, 1] *= 256 / w0
        spts[:, 2] *= 256 / h0
        want = tracker.track_points(resize_frames(big, (256, 256)), spts)
        traj = want["trajectories"].astype(np.float64) * np.array([w0 / 256, h0 / 256])
        _same_track("serve (b)", b, traj, want["visibilities"])
        got = np.asarray(b["trajectories"])
        qt = pts_big[:, 0].astype(int)
        at_query = np.abs(got[qt, np.arange(len(qt))] - pts_big[:, 1:]).max()
        moved = np.median(np.abs(got / np.array([w0 / 256, h0 / 256])
                                 - np.asarray(a["trajectories"])))
        print(f"serve (b): equals track_points on the host-resized frames and scaled points "
              f"bit for bit; query-frame rows within {at_query:.3f} px of the client's query "
              f"points; median |(b) - (a)| {moved:.3f} model px (two resamplings)", flush=True)
        if not at_query <= w0 / 256:
            raise AssertionError(f"serve (b): query-frame rows {at_query} px off the points")
        # (c) (a) and (b) at once, from two threads
        replies = [None, None]

        def post(i, arrays):
            replies[i] = _post_npz(port, "/v1/track", **arrays)[0]

        k1.reset_launches()
        threads = [threading.Thread(target=post, args=(0, dict(video=video, query_points=pts))),
                   threading.Thread(target=post, args=(1, dict(video=big, query_points=pts_big)))]
        t0 = time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        dt = time.time() - t0
        if any(t.is_alive() for t in threads):
            raise AssertionError("serve (c): a request did not return")
        check_launches("serve (c)", "highest", 2 * expect, "banked")
        for r, ref, name in zip(replies, (a, b), "ab"):
            if r is None or r["trajectories"] != ref["trajectories"] \
                    or r["visibilities"] != ref["visibilities"]:
                raise AssertionError(f"serve (c): request ({name}) differs from its serial answer")
        print(f"serve (c): (a) and (b) at once in {1e3 * dt:.1f} ms (server ms "
              f"{replies[0]['ms']:.2f}, {replies[1]['ms']:.2f}); each equals its serial answer",
              flush=True)
        # (d) /v1/vos: 24 frames at 480 x 854, three objects
        vos = SyntheticDavis(n_videos=1)
        frames, mask0 = vos.originals[0], vos.gt[0][0]
        n_obj = int(mask0.max())
        d = request("(d) /v1/vos 480x854", "/v1/vos", len(frames) - 1, video=frames,
                    first_mask=mask0)
        records["K1_square_serve"]["launches"] = len(frames) - 1
        masks = np.asarray(d["masks"])
        want = tracker.track_masks(resize_frames(frames, (256, 256)), mask0, SERVE_ORIG, n_obj)
        if d["num_objects"] != n_obj or masks.shape != want.shape or not np.array_equal(masks, want):
            raise AssertionError("serve (d): the masks differ from track_masks")
        t0 = time.perf_counter()
        body = serve.encode_reply({"masks": np.asarray(want).tolist(), "num_objects": n_obj,
                                   "ms": d["ms"]})
        encode_ms = 1e3 * (time.perf_counter() - t0)
        print(f"serve (d): masks equal track_masks label for label ({masks.size} labels); the "
              f"reply's encode (tolist + json.dumps) {encode_ms:.1f} ms for {len(body) / 1e6:.1f} "
              f"MB, beside {d['ms']:.2f} ms of resize and propagation", flush=True)
        # (e) liveness, counters, errors
        health, st = _http_status(port, "/healthz")[1], _http_status(port, "/stats")[1]
        bad = _http_status(port, "/v1/track", "POST", video=video[..., 0], query_points=pts)
        # small bodies where the server replies without reading them
        tiny = dict(video=video[:2, :16, :16], query_points=pts[:1])
        stats["config"]["max_request_mb"] = 0
        try:
            big_body = _http_status(port, "/v1/track", "POST", **tiny)
        finally:
            stats["config"]["max_request_mb"] = 512
        missing = _http_status(port, "/v1/nothing", "POST", **tiny)
        print(f"serve (e): /healthz {health}; /stats {st}; no channel axis -> {bad[0]} "
              f"{bad[1]['error'][:60]!r}; body over max_request_mb -> {big_body[0]}; unknown "
              f"path -> {missing[0]}", flush=True)
        if health.get("status") != "ok" or st["requests"] != 5 \
                or st["frames"] != 4 * T + len(frames):
            raise AssertionError(f"serve (e): /healthz {health}, /stats {st}")
        if (bad[0], big_body[0], missing[0]) != (400, 413, 404):
            raise AssertionError("serve (e): wrong error statuses")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    del tracker
    torch.cuda.empty_cache()
    # the kernel at /v1/vos's shape against its plain version, timed and bounded
    check_shape_kernels(records, {"K1_square_serve": (
        f"K1_square_serve {H}x{W} Cv {SERVE_CV}", H, W, C, SERVE_CV, "square")}, seed=4)
    print(f"serve phase {time.time() - t_phase:.1f} s", flush=True)


def run_export(records):
    """Phase export: the serving step exported on the card (256 x 256
    frame, 6 key slots, Cv 8), saved, loaded and run: K2 (circle) launched
    once through the operator, the loaded program equal to the step bit for
    bit and to the plain version by the kernel rule; timed; then the CLI
    with --check, and --format torch."""
    import torch

    from fgvc_tpu_torch.cli import export as export_cli
    from fgvc_tpu_torch.config import TestConfig
    from fgvc_tpu_torch.core.export import export_flagship, load_exported, save_exported
    from fgvc_tpu_torch.models.weights import export_reference_state_dict, read_pth
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    t_phase = time.time()
    exported, step, args = export_flagship(TestConfig(), value_dim=EXPORT_CV, device="cuda")
    t_export = time.time() - t_phase
    ops = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    if ops.count("fgvc_tpu_torch.topk_attention.default") != 1:
        raise AssertionError("export: the program lacks the operator's node")
    record = records["K2_circle_export"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        path = os.path.join(tmp, "step.pt2")
        size = save_exported(exported, path)
        program = load_exported(path).module()
        k1.reset_launches()
        with torch.no_grad():
            got = program(*args)
        torch.cuda.synchronize()
        counts = (k1.launches, k1.unbanked_launches, k1.row_block_launches, dict(k1.mode_launches))
        print(f"export: the loaded program's launches (banked, unbanked, row blocks, by mode) "
              f"{counts}", flush=True)
        if counts != (0, 1, 0, {"float32": 1, "high": 0, "bfloat16": 0}):
            raise AssertionError(f"export: launches {counts}, expected one unbanked 'float32'")
        record["launches"] = 1
        with torch.no_grad():
            direct = step(*args)
            x = step.preprocess(args[0][None]).permute(0, 3, 1, 2).contiguous()
            query = step.backbone(x).permute(0, 2, 3, 1)[0].contiguous()
        if not torch.equal(got, direct):
            raise AssertionError(f"export: the loaded program differs from the step by "
                                 f"{float((got - direct).abs().max())}")
        kw = dict(query=query, key=args[1], value=args[2], radius=RADIUS, temperature=TEMPERATURE,
                  topk=TOPK, normalize=True, tile=TILE, mask_shape="circle",
                  key_valid=[True] * SLOTS, compute_dtype="float32")
        ref = k1.topk_attention_plain(**kw)
        check_rows("export: loaded program vs plain", got, ref, KERNEL_TOL,
                   lambda: k1.near_tie_rows_plain_unbanked(**kw))
        del ref
        nbytes = 4.0 * (H * W * C + SLOTS * H * W * C + SLOTS * H * W * EXPORT_CV
                        + H * W * EXPORT_CV)
        check_entry("K2 circle (exported step)", record, k1.topk_attention,
                    k1.topk_attention_plain, k1.near_tie_rows_plain_unbanked,
                    {"distinct": (kw, kw["key_valid"])}, H, W, "circle", nbytes, "float32")
        with torch.no_grad():
            step_ms = _events_ms(lambda: program(*args), 20)
            direct_ms = _events_ms(lambda: step(*args), 20)
        print(f"export: artifact {size / 1e6:.2f} MB, exported in {t_export:.1f} s; the loaded "
              f"step {step_ms:.3f} ms, the module {direct_ms:.3f} ms (CUDA events; 256 x 256 "
              f"frame, {SLOTS} slots, Cv {EXPORT_CV}); equal bit for bit", flush=True)
        export_cli.main(["--out", os.path.join(tmp, "cli.pt2"), "--check",
                         "--value-dim", str(EXPORT_CV)])
        pth, out = os.path.join(tmp, "seeded.pth"), os.path.join(tmp, "student.pth")
        torch.save({"state_dict": export_reference_state_dict(step.backbone.state_dict())}, pth)
        export_cli.main(["--format", "torch", "--checkpoint", pth, "--out", out])
        a, b = read_pth(pth), read_pth(out)
        if set(a) != set(b) or not all(torch.equal(a[k], b[k]) for k in a):
            raise AssertionError("export --format torch: the re-normalised .pth differs")
    print(f"export phase {time.time() - t_phase:.1f} s", flush=True)


def run_doctor():
    """Phase doctor: python -m fgvc_tpu_torch.cli.doctor --json exits 0 and
    reports this card, nvcc, K1 against its plain version and the host codec
    library's JPEG round trip."""
    import torch

    t0 = time.time()
    out = subprocess.run([sys.executable, "-m", "fgvc_tpu_torch.cli.doctor", "--json"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"doctor exited {out.returncode}:\n{out.stdout[-3000:]}\n"
                             f"{out.stderr[-3000:]}")
    rep = json.loads(out.stdout)
    dev, nvcc = rep["checks"]["device"], rep["checks"]["nvcc"]
    print(f"doctor: exit 0 in {time.time() - t0:.1f} s; {dev['name']} ({dev['card']}); first op "
          f"{dev['first_op_s']} s; 1 MiB round trip {dev['transfer_MBps']} MB/s; build "
          f"{dev['build_s']} s; K1 vs plain {dev['k1']}; nvcc {nvcc.get('version')}; kernel "
          f"build {rep['checks']['kernel_build']['note']}; torch {rep['env']['torch']}, CUDA "
          f"{rep['env']['cuda']}; host codecs {rep['checks']['fgpack_native']}", flush=True)
    if (dev["name"] != torch.cuda.get_device_name(0) or not dev["k1"]["ok"] or not nvcc["ok"]
            or not rep["checks"]["fgpack_native"]["ok"]):
        raise AssertionError(f"doctor: unexpected report {rep}")

def make_kinetics_pickle(root, T=KIN_T, orig=KIN_ORIG, n_tracks=KIN_TRACKS, seed=0):
    """One TAP-Vid-Kinetics shard ({name: record}, as the release's are):
    a texture panning slowly at the original 360 x 640, every track inside
    the frame throughout, so each 5th frame queries all of them."""
    rng = np.random.default_rng(seed)
    h0, w0 = orig
    margin = int(0.2 * T) + 14  # past the largest shift: every track stays inside
    tex = _texture(rng, w0 + 2 * margin)
    vel = rng.uniform(-0.2, 0.2, 2)
    off = np.round(np.arange(T)[:, None] * vel[None]).astype(int) + margin
    video = np.stack([tex[oy:oy + h0, ox:ox + w0] for ox, oy in off])
    p0 = rng.uniform(margin, [w0 - margin, h0 - margin], (n_tracks, 2))
    pts = p0[:, None, :] - (off - off[0])[None].astype(np.float64)
    occ = (pts < 0).any(-1) | (pts[..., 0] > w0 - 1) | (pts[..., 1] > h0 - 1)
    with open(os.path.join(root, "kinetics_00000.pkl"), "wb") as f:
        pickle.dump({"kinetics_00000": {
            "video": video, "points": (pts / np.array([w0, h0])).astype(np.float32),
            "occluded": occ}}, f)


def _kernel_ms_per_launch(fn, launches):
    """Device ms per K1 launch (affinity_kernel + select_kernel) over fn(),
    which makes `launches` of them (torch.profiler; None where it saw no
    device time)."""
    by_kernel, _ = device_ms_by_kernel(fn)
    a = affinity_ms(by_kernel, launches)
    b = affinity_ms(by_kernel, launches, "select_kernel")
    return None if a is None or b is None else a + b


def _plain_propagation(fn):
    """fn() with the banked entry forced through its plain version."""
    import fgvc_tpu_torch.models.tracker as tracker_mod
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    tracker_mod.topk_attention_banked = k1.topk_attention_banked_plain
    try:
        return fn()
    finally:
        tracker_mod.topk_attention_banked = k1.topk_attention_banked


def _fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.3f} ms"


def run_kinetics(data_root, record):
    """run_task('kinetics', query_mode='strided') on one KIN_T-frame video
    stored at 360 x 640 (the host resize to 256 x 256 runs): K1 (circle)
    launches one per frame of each query group; metrics finite.  Then the
    last three query groups (the short ones) through K1 and through its
    plain version on the same features: median |diff| <= 1e-3 px from each
    point's query frame on."""
    import torch

    from fgvc_tpu_torch.apis.test import build_tracker, run_task
    from fgvc_tpu_torch.config import KINETICS_TEST_CFG
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ds = TapVidDataset(data_root, subset_name="kinetics", query_mode="strided")
    t0 = time.time()
    s = ds[0]
    t_read = time.time() - t0
    T = len(s["video"])
    qt = s["query_points"][:, 0].astype(int)
    groups = np.unique(qt)
    expect = int(sum(T - t - 1 for t in groups))
    k1.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    metrics = run_task("kinetics", data_root, device="cuda", seed=0, query_mode="strided")
    torch.cuda.synchronize()
    dt = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_launches("kinetics strided", "highest", expect, "banked")
    check_metrics(metrics)
    record["launches"] = (record["launches"] or 0) + expect
    print("kinetics strided metrics (random weights): " + json.dumps(
        {k: metrics[k] for k in ("average_pts_within_thresh", "average_jaccard",
                                 "pts_within_1", "pts_within_4", "pts_within_16")}))
    print(f"kinetics strided: {T} frames at {KIN_ORIG[0]} x {KIN_ORIG[1]} read and resized to "
          f"256 x 256 in {t_read:.2f} s; {len(s['query_points'])} queries in {len(groups)} "
          f"groups, {expect} K1 launches; run_task {dt:.2f} s = {T / dt:.2f} frames/s "
          f"(model build and data reading included), {1e3 * dt / expect:.3f} ms of wall time "
          f"per launch; peak device memory {peak:.2f} GB", flush=True)

    tracker = build_tracker(KINETICS_TEST_CFG, seed=0, device="cuda")
    feats = tracker.extract_features(s["video"])
    last = groups[-3:]
    sel = np.isin(qt, last)
    qp = s["query_points"][sel]
    n_last = int(sum(T - t - 1 for t in last))
    ms = _kernel_ms_per_launch(lambda: tracker.track_points(s["video"], qp, feats=feats), n_last)
    out_k = tracker.track_points(s["video"], qp, feats=feats)["trajectories"]
    out_p = _plain_propagation(
        lambda: tracker.track_points(s["video"], qp, feats=feats))["trajectories"]
    tracked = np.arange(T)[:, None] >= qp[:, 0][None].astype(int)  # from each query frame on
    diff = np.abs(out_k - out_p)[tracked]
    med = float(np.median(diff))
    print(f"kinetics strided last groups {list(last)} ({int(sel.sum())} queries, {n_last} "
          f"launches): K1 device {_fmt_ms(ms)} per launch (torch.profiler); kernel vs plain "
          f"median |diff| {med:.3e} px, max {diff.max():.3e} px (median limit {TRAJ_TOL_PX})",
          flush=True)
    if not med <= TRAJ_TOL_PX:
        raise AssertionError(f"kinetics: median trajectory difference {med} px > {TRAJ_TOL_PX}")


def run_zoo(data_root, jhmdb_root, records):
    """run_task('davis', backbone=NAME) for each entry of ZOO_ENTRIES at its
    published width with seeded weights, on video 0 of the e2e pickles (48
    frames, 256 x 256, 32 tracks, query groups at frames 0, 10 and 20): K1
    launches one per frame propagated, metrics finite.  Per entry: feature
    grid and C, backbone ms a frame (CUDA events over extract_features,
    upload and preprocessing included), ms a video (track_points), peak
    device memory of run_task, and the video through K1 and through its
    plain version on the same features: median |diff| <= 1e-3 px and <D
    within 0.1, as in phase plain.  Then dino_vit_b8 on one 24-frame 480 x
    880 VOS video, banked (K1 square at 60 x 110 x 768): launches, peak
    memory; each frame's K1 output on the kernel's path against the plain
    version on the same inputs: every row beyond 1e-4 must be a near-tie
    row (random DINO-B/8 features are nearly uniform, so 1-40% of a
    frame's rows are near-tie rows, and the kernel phase's 0.1% share does
    not apply); and the label maps against the plain version's end to end
    on >= 99.99% of pixels (each row that flips decodes to 64 pixels and
    carries to later frames).  Then swin_tiny on JHMDB's 320 x 320 must raise the ValueError of the
    JAX module's failure (stage 2 at 20 x 20, window 8).  Last, dino_vit_s16
    on the JHMDB tree through run_keypoints (K1 square at 20 x 20 x 384)."""
    import torch

    from fgvc_tpu_torch.apis.test import build_tracker, eval_vos, run_task
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ds = TapVidDataset(data_root)
    s = ds[0]
    video, qp = s["video"], s["query_points"]
    T = len(video)
    qt = qp[:, 0].astype(int)
    expect = int(sum(T - t - 1 for t in np.unique(qt)))
    record_of = {entry: key for key, (entry, *_rest) in ZOO_SHAPES.items()
                 if key.startswith("K1_circle")}
    for name in ZOO_ENTRIES:
        k1.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        metrics = run_task("davis", data_root, device="cuda", seed=0, backbone=name,
                           max_videos=1)
        torch.cuda.synchronize()
        dt = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        check_launches(f"zoo {name}", "highest", expect, "banked")
        check_metrics(metrics)
        if name in record_of:
            records[record_of[name]]["launches"] = expect
        tracker = build_tracker(DAVIS_TEST_CFG, seed=0, device="cuda", backbone=name)
        feats = tracker.extract_features(video)
        backbone_ms = _events_ms(lambda: tracker.extract_features(video), 3) / T
        torch.cuda.synchronize()
        t0 = time.time()
        tracker.track_points(video, qp)
        torch.cuda.synchronize()
        video_ms = 1e3 * (time.time() - t0)
        out_k = tracker.track_points(video, qp, feats=feats)["trajectories"]
        out_p = _plain_propagation(
            lambda: tracker.track_points(video, qp, feats=feats))["trajectories"]
        tracked = np.arange(T)[:, None] >= qt[None]  # from each query frame on
        diff = np.abs(out_k - out_p)[tracked]
        med = float(np.median(diff))
        delta = [ds.evaluate([{
            "trajectories_gt": s["trajectories"], "visibilities_gt": s["visibilities"],
            "trajectories_pred": out, "visibilities_pred": np.zeros(out.shape[:2], bool),
            "query_points": qp}])["average_pts_within_thresh"] for out in (out_k, out_p)]
        print(f"zoo {name}: grid {tuple(feats.shape[1:3])}, C {feats.shape[3]}; {expect} K1 "
              f"launches; backbone {backbone_ms:.3f} ms a frame; {video_ms:.1f} ms a video "
              f"(track_points, {T} frames); run_task {dt:.2f} s; peak device memory "
              f"{peak:.2f} GB; K1 vs plain (same features) median |diff| {med:.3e} px, "
              f"max {diff.max():.3e} px, <D {delta[0]:.4f} vs {delta[1]:.4f}", flush=True)
        if not med <= TRAJ_TOL_PX:
            raise AssertionError(f"zoo {name}: median trajectory difference {med} px")
        if not abs(delta[0] - delta[1]) <= DELTA_D_TOL:
            raise AssertionError(f"zoo {name}: <D differs by {abs(delta[0] - delta[1])}")
        del tracker, feats
        torch.cuda.empty_cache()

    vos = SyntheticDavis(n_videos=1)
    tracker = build_tracker(DAVIS_TEST_CFG, seed=0, device="cuda", backbone="dino_vit_b8")
    k1.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = eval_vos(tracker, vos)
    torch.cuda.synchronize()
    dt = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = len(vos.videos[0]) - 1
    check_launches("zoo vos dino_vit_b8", "highest", n, "banked")
    records["K1_square_vos_b8"]["launches"] = n
    v = vos[0]
    backbone_ms = _events_ms(lambda: tracker.extract_features(v["video"]), 1) / len(v["video"])
    args = (v["video"], v["first_mask"], tuple(v["original_shape"]), v["num_objects"])
    rows = np.zeros(4, np.int64)  # beyond the limit, of them not near ties, near ties, all
    errs = []

    def checked(qpad, kpad, value, **kw):
        """K1 on the kernel's own path, each frame's rows beyond KERNEL_TOL
        of the plain version on the same inputs counted, and those that are
        not near-tie rows of the plain affinities."""
        out = k1.topk_attention_banked(qpad, kpad, value, **kw)
        d = (out - k1.topk_attention_banked_plain(qpad, kpad, value, **kw)).abs().amax(-1)
        beyond, near = d > KERNEL_TOL, k1.near_tie_rows_plain(qpad, kpad, value, **kw)
        rows[:] += [int(beyond.sum()), int((beyond & ~near).sum()), int(near.sum()), d.numel()]
        errs.append(float(d.max()))
        return out

    import fgvc_tpu_torch.models.tracker as tracker_mod

    tracker_mod.topk_attention_banked = checked
    try:
        out_k = tracker.track_masks(*args)
    finally:
        tracker_mod.topk_attention_banked = k1.topk_attention_banked
    out_p = _plain_propagation(lambda: tracker.track_masks(*args))
    agree = _agreement([out_k], [out_p])
    print(f"zoo vos dino_vit_b8: J&F (random weights) {json.dumps(res)}; {n} K1 square "
          f"launches at {VOS_H // 4}x{VOS_W // 4}x768; backbone {backbone_ms:.2f} ms a "
          f"frame at 480 x 880; eval_vos {dt:.2f} s (scoring included); peak device memory "
          f"{peak:.2f} GB", flush=True)
    print(f"zoo vos dino_vit_b8 K1 vs plain per frame on the kernel's path: max |diff| "
          f"{max(errs):.3e}; {rows[0]} of {rows[3]} rows beyond {KERNEL_TOL:.0e}, {rows[1]} "
          f"of them not near-tie rows (must be 0); {rows[2]} near-tie rows in all (random "
          f"DINO-B/8 features are nearly uniform); label maps agree with the plain "
          f"version's end to end on {100 * agree:.5f}% of pixels (limit {100 * MASK_AGREE}%)",
          flush=True)
    if rows[1]:
        raise AssertionError(f"zoo vos: {rows[1]} rows differ from plain beyond a near tie")
    if not np.isfinite(res["J&F-Mean"]):
        raise AssertionError(f"zoo vos: J&F-Mean is not finite: {res}")
    if not np.array_equal(out_k, vos.preds[0]):
        raise AssertionError("zoo vos: the checked run's label maps differ from eval_vos's")
    if not agree >= MASK_AGREE:
        raise AssertionError(f"zoo vos: masks agree on {agree} < {MASK_AGREE}")
    del tracker
    torch.cuda.empty_cache()

    try:
        run_task("jhmdb", data_root, device="cuda", backbone="swin_tiny")
    except ValueError as e:
        print(f"zoo swin_tiny on JHMDB 320 x 320 refused: {e}", flush=True)
        if "stage 2 at 20x20" not in str(e) or "window 8" not in str(e):
            raise AssertionError(f"zoo swin_tiny: unexpected message {e}") from e
    else:
        raise AssertionError("zoo swin_tiny on JHMDB's 320 x 320 ran; JAX fails there")
    run_keypoints("jhmdb", jhmdb_root, records["K1_square_jhmdb_s16"], [JHMDB_T] * JHMDB_VIDEOS,
                  JHMDB_ORIG, backbone="dino_vit_s16")


def encode_png(path, img, palette=None):
    """Write a PNG (the port's writer): (H, W, 3) uint8 RGB, or (H, W) uint8
    palette indices with `palette` ((n, 3) uint8 RGB)."""
    from fgvc_tpu_torch.utils.visualize import png_bytes

    with open(path, "wb") as f:
        f.write(png_bytes(img, palette))


def _panning(rng, T, orig, speed):
    """(T, h, w, 3) frames of a texture panning by up to `speed` pixels a
    frame and the (T, 2) (x, y) offsets from frame 0."""
    h0, w0 = orig
    margin = int(np.ceil(speed * T))
    tex = _texture(rng, max(h0, w0) + 2 * margin)
    vel = rng.uniform(-speed, speed, 2)
    off = np.round(np.arange(T)[:, None] * vel[None]).astype(int) + margin
    frames = np.stack([tex[oy:oy + h0, ox:ox + w0] for ox, oy in off])
    return frames, (off - off[0]).astype(np.float64)


def make_jhmdb_tree(root, n_videos=JHMDB_VIDEOS, T=JHMDB_T, orig=JHMDB_ORIG, seed=0):
    """A JHMDB tree: PNG frames (written with zlib), a .mat of 1-based
    pos_img (2, 15, T) per video through scipy.io.savemat (15 joints
    following the pan), val_list.txt."""
    import scipy.io as sio

    rng = np.random.default_rng(seed)
    lines = []
    for v in range(n_videos):
        vdir = os.path.join(root, "Frames", f"v{v}")
        os.makedirs(vdir, exist_ok=True)
        frames, off = _panning(rng, T, orig, 1.0)
        for t, frame in enumerate(frames):
            path = os.path.join(vdir, f"{t + 1:05d}.png")
            encode_png(path, frame)
        # joints within 20 px of the centre: PCK@0.1 is about 3 px
        j0 = np.array([orig[1] / 2, orig[0] / 2]) + rng.uniform(-20, 20, (15, 2))
        pos = (j0[None] - off[:, None]).transpose(2, 1, 0)  # (2, 15, T) (x; y)
        sio.savemat(os.path.join(root, f"v{v}.mat"), {"pos_img": pos + 1})
        lines.append(f"v{v}.mat Frames/v{v}")
    with open(os.path.join(root, "val_list.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


# DAVIS's palette: 0 background, 1 (128, 0, 0), 2 (0, 128, 0)
DAVIS_PALETTE = np.array([[0, 0, 0], [128, 0, 0], [0, 128, 0]] + [[0, 0, 0]] * 253, np.uint8)


def make_badja_tree(root, T=BADJA_T, orig=BADJA_ORIG, every=BADJA_EVERY, seed=0):
    """A BADJA tree for one animal: JPEG frames at quality 95 (the port's
    encoder, one thread a frame), joint_annotations/<animal>.json (37 SMAL
    joints (y, x) following the pan, on every 5th frame and the last) and
    palette PNG segmentations (written with zlib; the animal an ellipse,
    label 1, a second object label 2)."""
    from concurrent.futures import ThreadPoolExecutor

    from fgvc_tpu_torch.data_io.fgpack import encode_jpeg

    rng = np.random.default_rng(seed)
    animal = "dog"
    adir = os.path.join(root, "Annotations", "Full-Resolution", animal)
    os.makedirs(adir, exist_ok=True)
    os.makedirs(os.path.join(root, "joint_annotations"), exist_ok=True)
    frames, off = _panning(rng, T, orig, 3.0)
    h0, w0 = orig
    yy, xx = np.mgrid[:h0, :w0]
    j0 = np.array([h0 / 2, w0 / 2]) + rng.uniform(-100, 100, (37, 2))  # (y, x), on the animal
    entries = []
    jdir = os.path.join(root, "JPEGImages", "Full-Resolution", animal)
    os.makedirs(jdir, exist_ok=True)

    def write_jpeg(t):
        with open(os.path.join(jdir, f"{t:05d}.jpg"), "wb") as f:
            f.write(encode_jpeg(frames[t], 95))

    with ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(write_jpeg, range(T)))
    for t in range(T):
        seg = os.path.join(adir, f"{t:05d}.png")
        cy, cx = h0 / 2 - off[t, 1], w0 / 2 - off[t, 0]
        # radii 120 x 180 px: PCK@0.1 is about 7 px at 320 x 512
        labels = (((yy - cy) / 120) ** 2 + ((xx - cx) / 180) ** 2 <= 1).astype(np.uint8)
        labels[:200, :300] = 2
        encode_png(seg, labels, DAVIS_PALETTE)
        if t % every == 0 or t == T - 1:
            entries.append({
                "image_path": f"badja/JPEGImages/Full-Resolution/{animal}/{t:05d}.jpg",
                "segmentation_path": f"badja/Annotations/Full-Resolution/{animal}/{t:05d}.png",
                "joints": (j0 - off[t, ::-1]).tolist(),
                "visibility": [1] * 37,
            })
    with open(os.path.join(root, "joint_annotations", f"{animal}.json"), "w") as f:
        json.dump(entries, f)
    return len(entries)


def run_keypoints(task, root, record, n_frames, decode_hw, backbone="resnet18_d1"):
    """run_task(task) ('jhmdb' or 'badja') on the tree's files with
    `backbone` (ResNet-18-d1 or a zoo entry): K1 (square) launches one per frame
    propagated, PCK finite; then video 0 profiled (K1 device ms per launch)
    and propagated again through the plain version on the same features:
    median |diff| <= 1e-3 px, PCK of both printed."""
    import torch

    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, build_tracker, run_task
    from fgvc_tpu_torch.datasets.badja import BadjaDataset
    from fgvc_tpu_torch.datasets.jhmdb import JhmdbDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ds = JhmdbDataset(root, root) if task == "jhmdb" else BadjaDataset(root, root)
    label = task if backbone == "resnet18_d1" else f"zoo {task} {backbone}"
    expect = sum(n - 1 for n in n_frames)
    k1.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    metrics = run_task(task, root, device="cuda", seed=0, backbone=backbone)
    torch.cuda.synchronize()
    dt = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_launches(label, "highest", expect, "banked")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{label}: PCK not finite: {metrics}")
    record["launches"] = (record["launches"] or 0) + expect
    print(f"{label} PCK (random weights): " + json.dumps(metrics))
    print(f"{label}: {len(ds)} video(s), {sum(n_frames)} frames in {dt:.2f} s = "
          f"{sum(n_frames) / dt:.2f} frames/s (model build, data reading and scoring "
          f"included); {expect} K1 launches; peak device memory {peak:.2f} GB", flush=True)

    t0 = time.time()
    s = ds[0]
    print(f"{label} video 0 read from its files (the port's decoders) in "
          f"{time.time() - t0:.2f} s", flush=True)
    tracker = build_tracker(TASK_CONFIGS[task], seed=0, device="cuda", backbone=backbone)
    feats = tracker.extract_features(s["video"])
    args = (s["video"], s["ref_maps"], tuple(s["original_shape"]))
    ms = _kernel_ms_per_launch(lambda: tracker.track_heatmaps(*args, feats=feats),
                               n_frames[0] - 1)
    t0 = time.time()
    out_k = tracker.track_heatmaps(*args, feats=feats)
    t_k = time.time() - t0
    t0 = time.time()
    out_p = _plain_propagation(lambda: tracker.track_heatmaps(*args, feats=feats))
    t_p = time.time() - t0
    diff = np.abs(out_k - out_p)
    med = float(np.median(diff))
    if task == "jhmdb":
        pck = [ds.evaluate([np.transpose(o, (2, 1, 0))], indices=[0]) for o in (out_k, out_p)]
    else:
        pck = [ds.evaluate([o], indices=[0]) for o in (out_k, out_p)]
    dpck = max(abs(pck[0][k] - pck[1][k]) for k in pck[0])
    print(f"{label} video 0 ({n_frames[0]} frames, decode {decode_hw}): K1 device "
          f"{_fmt_ms(ms)} per launch (torch.profiler); propagation+decode {1e3 * t_k:.1f} ms "
          f"with K1, {1e3 * t_p:.1f} ms with the plain version; coordinates median |diff| "
          f"{med:.3e} px, max {diff.max():.3e} px (median limit {TRAJ_TOL_PX}); PCK "
          f"{json.dumps(pck[0])} vs plain {json.dumps(pck[1])} (largest |diff| {dpck})",
          flush=True)
    if not med <= TRAJ_TOL_PX:
        raise AssertionError(f"{label}: median coordinate difference {med} px > {TRAJ_TOL_PX}")
    return metrics


def run_sp_jhmdb(root, record, card):
    """JHMDB video 0 through track_heatmaps unsharded and with `card` listed
    twice (K4 square, two row blocks a frame): coordinates equal bit for
    bit."""
    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, build_tracker
    from fgvc_tpu_torch.datasets.jhmdb import JhmdbDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    S = 2
    s = JhmdbDataset(root, root)[0]
    args = (s["video"], s["ref_maps"], tuple(s["original_shape"]))
    single = build_tracker(TASK_CONFIGS["jhmdb"], seed=0, device=card).track_heatmaps(*args)
    tracker = build_tracker(TASK_CONFIGS["jhmdb"], seed=0, spatial_devices=[card] * S)
    k1.reset_launches()
    sp, peak = _peak_gb_of(lambda: tracker.track_heatmaps(*args))
    expect = S * (len(s["video"]) - 1)
    check_launches(f"sp jhmdb S={S}", "highest", expect, "row_block")
    record["launches"] = (record["launches"] or 0) + expect
    d = float(np.abs(sp - single).max())
    print(f"sp jhmdb S={S} on one card: coordinates vs unsharded max |diff| {d:.3e} px (must be "
          f"0); peak device memory {peak:.2f} GB", flush=True)
    if not np.array_equal(sp, single):
        raise AssertionError("sp jhmdb: row blocks differ from the unsharded run")



def _sha256(data):
    import hashlib

    return hashlib.sha256(data).hexdigest()


def _host_ms(fn, n, reps=3):
    """Median host ms of fn() over reps calls, divided by the n items it
    handles."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times)) / n


def run_codec_build_and_pins():
    """Build the host library with g++ (timed) and hold the codecs to the
    CODEC_PINS; returns the build seconds."""
    from fgvc_tpu_torch.data_io import fgpack

    t0 = time.time()
    lib = fgpack.build_library(force=True)
    build_s = time.time() - t0
    print(f"codecs: {os.path.relpath(lib, ROOT)} built in {build_s:.2f} s by "
          f"{fgpack.compiler_version()} (g++ {' '.join(fgpack.CXX_FLAGS + fgpack.LINK_FLAGS)}; "
          f"no nvcc)", flush=True)
    for h, w in CODEC_PIN_SHAPES:
        frame = codec_pin_frame(h, w)
        enc = fgpack.encode_jpeg(frame, CODEC_PIN_QUALITY)
        got = (_sha256(enc), _sha256(fgpack.decode_jpeg(enc).tobytes()))
        want = CODEC_PINS[f"{h}x{w}"]
        print(f"codecs pin {h}x{w} quality {CODEC_PIN_QUALITY}: {len(enc)} bytes; sha256 of "
              f"the bytes {got[0][:16]}.., of the pixels {got[1][:16]}.. "
              f"({'equal to' if got == want else 'NOT'} libjpeg's)", flush=True)
        if got != want:
            raise AssertionError(f"codecs pin {h}x{w}: sha256 {got}, expected {want}")
    return build_s


def run_codec_times(root, card_name):
    """Host ms a CODEC_HW frame for each codec and FgPack.read_batch's MB/s
    over a PACK_FRAMES-frame JPEG pack, one thread and os.cpu_count()."""
    from fgvc_tpu_torch.data_io import fgpack
    from fgvc_tpu_torch.datasets.image_io import read_image, read_png_indices

    n_cpu = os.cpu_count() or 1
    h, w = CODEC_HW
    frames = np.stack([codec_pin_frame(h, w, seed=1 + i) for i in range(CODEC_FRAMES)])
    bufs = [fgpack.encode_jpeg(f, 95) for f in frames]
    times = {
        "encode": _host_ms(lambda: [fgpack.encode_jpeg(f, 95) for f in frames], CODEC_FRAMES),
        "decode_1": _host_ms(lambda: fgpack.decode_jpeg_batch(bufs, n_threads=1), CODEC_FRAMES),
        f"decode_{n_cpu}": _host_ms(lambda: fgpack.decode_jpeg_batch(bufs, n_threads=n_cpu),
                                    CODEC_FRAMES),
        "i420": _host_ms(lambda: fgpack.rgb_to_i420_batch(frames), CODEC_FRAMES),
    }
    paths = []
    for t, b in enumerate(bufs):
        paths.append(os.path.join(root, f"frame_{t:05d}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(b)
    rgb_png, pal_png = os.path.join(root, "rgb.png"), os.path.join(root, "palette.png")
    encode_png(rgb_png, frames[0])
    yy, xx = np.mgrid[:h, :w]
    encode_png(pal_png, ((yy // 60 + xx // 90) % 3).astype(np.uint8), DAVIS_PALETTE)
    times["png_rgb"] = _host_ms(lambda: [read_image(rgb_png) for _ in range(4)], 4)
    times["png_palette"] = _host_ms(lambda: [read_png_indices(pal_png) for _ in range(4)], 4)
    # the DAVIS reader's path: a video's JPEG files one after another
    video_s = _host_ms(lambda: [read_image(p) for p in paths], 1000)
    batch_s = _host_ms(lambda: fgpack.decode_jpeg_batch(bufs, n_threads=n_cpu), 1000)
    print(f"codecs host ms a {h}x{w} frame ({card_name}; os.cpu_count() {n_cpu}; median of 3): "
          + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
          + f"; JPEG bytes a frame {np.mean([len(b) for b in bufs]) / 1e3:.1f} KB", flush=True)
    print(f"codecs: a {CODEC_FRAMES}-frame {h}x{w} video decodes in {video_s:.3f} s file by file "
          f"(read_image, the DAVIS reader's path) and {batch_s:.3f} s in one "
          f"decode_jpeg_batch on {n_cpu} threads", flush=True)

    pack_path = os.path.join(root, "frames.fgpack")
    pack_frames = [codec_pin_frame(*PACK_HW, seed=100 + i) for i in range(PACK_FRAMES)]
    t0 = time.perf_counter()
    fgpack.write_fgpack(pack_path, pack_frames, codec="jpeg")
    write_s = time.perf_counter() - t0
    size_mb = os.path.getsize(pack_path) / 1e6
    rates = {}
    with fgpack.FgPack(pack_path) as pack:
        idx = list(range(PACK_FRAMES))
        for layout, bpp in (("hwc", 3.0), ("i420", 1.5)):
            out_mb = PACK_FRAMES * PACK_HW[0] * PACK_HW[1] * bpp / 1e6
            for threads in (1, n_cpu):
                ms = _host_ms(lambda: pack.read_batch(idx, n_threads=threads, layout=layout), 1)
                rates[f"{layout}_{threads}"] = out_mb / (ms / 1e3)
    print(f"codecs pack: {PACK_FRAMES} JPEG frames {PACK_HW[0]}x{PACK_HW[1]} at q95, "
          f"{size_mb:.2f} MB, written in {write_s:.2f} s; FgPack.read_batch decoded MB/s "
          + ", ".join(f"{k} threads {v:.1f}" for k, v in rates.items()) + f" ({card_name})",
          flush=True)
    return times, rates


class _KeptDavis:
    """A DavisVosDataset whose score_video keeps the predicted label maps."""

    def __init__(self, ds):
        self.ds, self.preds = ds, {}

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]

    def score_video(self, i, pred):
        self.preds[i] = pred
        return self.ds.score_video(i, pred)


def run_codec_vos(root, records):
    """A DAVIS tree written by the port's encoders (one synthetic video:
    JPEG frames at quality 95, palette PNG annotations): run_task('vos')
    through K1 square, then eval_vos on the tree and on the decoded arrays
    in memory: label maps equal, J&F equal."""
    import torch

    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, build_tracker, eval_vos, run_task
    from fgvc_tpu_torch.data_io.fgpack import decode_jpeg_batch, encode_jpeg
    from fgvc_tpu_torch.datasets.davis_vos import INPUT_SIZE, DavisVosDataset, resize_frames
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    syn = SyntheticDavis(n_videos=1, seed=3)
    tree, seq = os.path.join(root, "davis"), "synthetic_0"
    jdir = os.path.join(tree, "JPEGImages", "480p", seq)
    adir = os.path.join(tree, "Annotations", "480p", seq)
    for d in (jdir, adir, os.path.join(tree, "ImageSets", "2017")):
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(tree, "ImageSets", "2017", "val.txt"), "w") as f:
        f.write(seq + "\n")
    bufs = []
    for t, (frame, labels) in enumerate(zip(syn.originals[0], syn.gt[0])):
        bufs.append(encode_jpeg(frame, 95))
        with open(os.path.join(jdir, f"{t:05d}.jpg"), "wb") as f:
            f.write(bufs[-1])
        encode_png(os.path.join(adir, f"{t:05d}.png"), labels, DAVIS_PALETTE)
    T = len(bufs)
    k1.reset_launches()
    t0 = time.time()
    metrics = run_task("vos", tree, device="cuda", seed=0)
    torch.cuda.synchronize()
    dt = time.time() - t0
    check_launches("codecs vos from files", "highest", T - 1, "banked")
    _add_launches(records["K1_square"], T - 1)
    # the same run fed the decoded arrays
    mem = SyntheticDavis.__new__(SyntheticDavis)
    mem.originals, mem.gt, mem.preds = syn.originals, syn.gt, {}
    mem.videos = [resize_frames(decode_jpeg_batch(bufs), INPUT_SIZE)]
    tracker = build_tracker(TASK_CONFIGS["vos"], seed=0, device="cuda")
    files = _KeptDavis(DavisVosDataset(tree))
    res_file, res_mem = eval_vos(tracker, files), eval_vos(tracker, mem)
    same = np.array_equal(files.preds[0], mem.preds[0])
    h0, w0 = syn.originals[0].shape[1:3]
    print(f"codecs vos from files ({T} JPEG frames {h0}x{w0}, palette PNGs): run_task J&F-Mean "
          f"{metrics['J&F-Mean']:.6f} in {dt:.2f} s (reading included); eval_vos on the files "
          f"{res_file['J&F-Mean']:.6f}, on the decoded arrays {res_mem['J&F-Mean']:.6f}; label "
          f"maps {'equal' if same else 'DIFFERENT'}", flush=True)
    if not same or res_file != res_mem or metrics["J&F-Mean"] != res_mem["J&F-Mean"]:
        raise AssertionError(f"codecs vos: files {res_file} / {metrics} vs arrays {res_mem}")


def run_codec_tapvid(data_root, root, records):
    """The e2e pickles with their frames as JPEG bytes (the port's encoder,
    quality 95), and as a uint8 pickle of the same frames decoded:
    run_task('davis') through K1 circle on each, metrics equal."""
    import glob

    import torch

    from fgvc_tpu_torch.apis.test import run_task
    from fgvc_tpu_torch.data_io.fgpack import decode_jpeg_batch, encode_jpeg
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    roots = {"jpeg": os.path.join(root, "tapvid_jpeg"), "uint8": os.path.join(root, "tapvid_u8")}
    for d in roots.values():
        os.makedirs(d)
    nbytes = {"jpeg": 0, "uint8": 0}
    for path in sorted(glob.glob(os.path.join(data_root, "*.pkl"))):
        with open(path, "rb") as f:
            rec = pickle.load(f)
        bufs = [encode_jpeg(frame, 95) for frame in rec["video"]]
        for kind, video in (("jpeg", bufs), ("uint8", decode_jpeg_batch(bufs))):
            with open(os.path.join(roots[kind], os.path.basename(path)), "wb") as f:
                pickle.dump(dict(rec, video=video), f)
            nbytes[kind] += os.path.getsize(os.path.join(roots[kind], os.path.basename(path)))
    expect = frames_propagated(TapVidDataset(roots["jpeg"]))
    metrics = {}
    for kind in ("jpeg", "uint8"):
        k1.reset_launches()
        t0 = time.time()
        metrics[kind] = run_task("davis", roots[kind], device="cuda", seed=0)
        torch.cuda.synchronize()
        dt = time.time() - t0
        check_launches(f"codecs davis, {kind} pickles", "highest", expect, "banked")
        _add_launches(records["K1_circle"], expect)
        print(f"codecs davis, {kind} pickles ({nbytes[kind] / 1e6:.1f} MB): <D "
              f"{metrics[kind]['average_pts_within_thresh']:.6f} in {dt:.2f} s (reading and "
              f"decoding included)", flush=True)
    if metrics["jpeg"] != metrics["uint8"]:
        raise AssertionError(f"codecs davis: JPEG-byte metrics {metrics['jpeg']} differ from "
                             f"the decoded frames' {metrics['uint8']}")


def run_codec_yuv420(data_root, records):
    """upload_format 'yuv420' against 'rgb' on the e2e pickles: K1 launches
    one per frame propagated in both, <D and the bytes uploaded; then the
    8-frame 128 x 128 cut on the card against the CPU."""
    import dataclasses

    import torch

    from fgvc_tpu_torch.apis.test import build_tracker, run_task
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ds = TapVidDataset(data_root)
    expect = frames_propagated(ds)
    videos = [ds[i]["video"] for i in range(len(ds))]
    out = {}
    for fmt in ("rgb", "yuv420"):
        cfg = dataclasses.replace(DAVIS_TEST_CFG, upload_format=fmt)
        tracker = build_tracker(cfg, seed=0, device="cuda")
        nbytes = sum(tracker.upload_video(v).nbytes for v in videos)
        t0 = time.perf_counter()
        for v in videos:
            tracker.upload_video(v)
        host_ms = 1e3 * (time.perf_counter() - t0) / sum(len(v) for v in videos)
        del tracker
        k1.reset_launches()
        t0 = time.time()
        m = run_task("davis", data_root, device="cuda", seed=0, test_cfg=cfg)
        torch.cuda.synchronize()
        dt = time.time() - t0
        check_launches(f"codecs davis upload_format {fmt}", "highest", expect, "banked")
        _add_launches(records["K1_circle"], expect)
        out[fmt] = m["average_pts_within_thresh"]
        print(f"codecs davis upload_format {fmt}: <D {out[fmt]:.6f}; {nbytes / 1e6:.2f} MB "
              f"uploaded for {len(videos)} videos ({nbytes / sum(v.nbytes for v in videos):.2f} "
              f"of RGB), host encode {host_ms:.3f} ms a frame; run {dt:.2f} s", flush=True)
    print(f"codecs: 'yuv420' <D - 'rgb' <D = {out['yuv420'] - out['rgb']:+.6f}", flush=True)
    _prop_cut_card_vs_cpu(ds[0], {"yuv420": dict(upload_format="yuv420")}, forward=False,
                          tag="codecs")


def _exif_expected(img, orientation):
    """cv2's EXIF transforms, written out with numpy's rotations."""
    t = img.transpose(1, 0, 2)
    return {1: img, 2: img[:, ::-1], 3: np.rot90(img, 2), 4: img[::-1], 5: t,
            6: np.rot90(img, -1), 7: np.rot90(t, 2), 8: np.rot90(img, 1)}[orientation]


def run_codec_fixtures(card_name):
    """(f) The committed fixtures against FIXTURE_PINS; the EXIF files,
    orientations 1-8, against the numpy transforms and EXIF_PINS; the
    progressive decode's host ms beside the baseline decode's; the WebP
    fixtures' decode ms."""
    from fgvc_tpu_torch.data_io import fgpack
    from fgvc_tpu_torch.datasets.image_io import read_image

    fixtures = {}
    for name, pin in FIXTURE_PINS.items():
        with open(os.path.join(ROOT, FIXTURE_DIR, name), "rb") as f:
            fixtures[name] = f.read()
        got = read_image(fixtures[name])
        ok = _sha256(got.tobytes()) == pin
        print(f"codecs fixture {name} ({len(fixtures[name])} bytes): {got.shape[0]}x"
              f"{got.shape[1]}, sha256 of the pixels {'equal to' if ok else 'NOT'} PIL's and "
              "cv2's", flush=True)
        if not ok:
            raise AssertionError(f"codecs fixture {name}: pixels differ from PIL's and cv2's")
    img = codec_pin_frame(*EXIF_HW, seed=EXIF_SEED)
    plain = fgpack.decode_jpeg(fgpack.encode_jpeg(img, 95))
    shapes = {}
    for o, pin in EXIF_PINS.items():
        data = exif_jpeg(img, exif_tiff(o, little=o % 2 == 1))
        got = read_image(data)
        want = _exif_expected(plain, o)
        shapes[o] = got.shape[:2]
        if not (np.array_equal(got, want) and _sha256(got.tobytes()) == pin
                and np.array_equal(read_image(data, "unchanged"), plain[..., ::-1])
                and np.array_equal(fgpack.decode_jpeg(data), plain)):
            raise AssertionError(f"codecs EXIF orientation {o}: read_image differs from cv2's")
    print("codecs EXIF orientations 1-8 (II for odd, MM for even): read_image equal to the "
          f"transforms and to cv2's pins, shapes {shapes}; 'unchanged' and decode_jpeg "
          "unrotated", flush=True)
    n_cpu = os.cpu_count() or 1
    prog = fixtures["progressive_q95_480x854.jpg"]
    base = fgpack.encode_jpeg(fgpack.decode_jpeg(prog), 95)
    ms = {}
    for label, data in (("progressive", prog), ("baseline", base)):
        for threads in (1, n_cpu):
            ms[f"{label}_{threads}"] = _host_ms(
                lambda: fgpack.decode_jpeg_batch([data] * CODEC_FRAMES, n_threads=threads),
                CODEC_FRAMES)
    print(f"codecs host ms a 480x854 q95 frame ({card_name}; median of 3, {CODEC_FRAMES} "
          f"frames a call): progressive {ms['progressive_1']:.2f} on 1 thread, "
          f"{ms[f'progressive_{n_cpu}']:.2f} on {n_cpu}; baseline of the same pixels "
          f"{ms['baseline_1']:.2f} and {ms[f'baseline_{n_cpu}']:.2f} ({len(prog) / 1e3:.1f} "
          f"against {len(base) / 1e3:.1f} KB)", flush=True)
    webp_ms = {name: _host_ms(lambda data=data: read_image(data), 1, reps=5)
               for name, data in fixtures.items() if name.endswith(".webp")}
    print(f"codecs WebP host ms a frame ({card_name}; read_image, median of 5, one thread): "
          + ", ".join(f"{name} ({len(fixtures[name]) / 1e3:.1f} KB) {v:.2f}"
                      for name, v in webp_ms.items()), flush=True)


def progressive_cut(data, k):
    """A progressive JPEG cut before its (k + 1)-th scan, EOI appended: the
    markers walked, each scan's entropy data skipped to the next marker."""
    pos, starts = 2, []
    while data[pos + 1] != 0xD9:
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] != 0xDA:
            pos += 2 + length
            continue
        starts.append(pos)
        pos += 2 + length
        while not (data[pos] == 0xFF and data[pos + 1] != 0 and not 0xD0 <= data[pos + 1] <= 0xD7):
            pos += 1
    return data[:starts[k]] + b"\xff\xd9"


def run_codec_forms(card_name):
    """(g) The CMYK fixture and the progressive fixture's cuts against
    JPEG_FORM_PINS; their host ms a frame beside the baseline decode."""
    from fgvc_tpu_torch.data_io import fgpack
    from fgvc_tpu_torch.datasets.image_io import read_image

    with open(os.path.join(ROOT, CMYK_DIR, CMYK_FIXTURE), "rb") as f:
        cmyk = f.read()
    with open(os.path.join(ROOT, FIXTURE_DIR, "progressive_q95_480x854.jpg"), "rb") as f:
        prog = f.read()
    cases = {"cmyk_pil": (cmyk, fgpack.decode_jpeg), "cmyk_cv2": (cmyk, read_image)}
    for k in PROGRESSIVE_CUTS:
        cases[f"progressive_{k}"] = (progressive_cut(prog, k), fgpack.decode_jpeg)
    base = fgpack.encode_jpeg(fgpack.decode_jpeg(prog), 95)
    ms = {"baseline": _host_ms(lambda: fgpack.decode_jpeg(base), 1, reps=5),
          "progressive (all 10 scans)": _host_ms(lambda: fgpack.decode_jpeg(prog), 1, reps=5)}
    for name, (data, fn) in cases.items():
        got = fn(data)
        if _sha256(got.tobytes()) != JPEG_FORM_PINS[name]:
            raise AssertionError(f"codecs {name}: pixels differ from PIL's and cv2's pin")
        ms[f"{name} {got.shape}"] = _host_ms(lambda data=data, fn=fn: fn(data), 1, reps=5)
    print("codecs JPEG forms: the CMYK fixture (decode_jpeg as PIL, read_image as cv2) and the "
          f"progressive fixture cut after {PROGRESSIVE_CUTS} scans (smoothed) equal to their "
          f"pins; host ms a 480x854 frame ({card_name}; median of 5, one thread): "
          + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()), flush=True)


def run_codecs(data_root, records, card_name):
    """Phase codecs (see the module's docstring)."""
    t_phase = time.time()
    build_s = run_codec_build_and_pins()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_codecs_") as root:
        run_codec_times(root, card_name)
        run_codec_vos(root, records)
        run_codec_tapvid(data_root, root, records)
    run_codec_yuv420(data_root, records)
    run_codec_fixtures(card_name)
    run_codec_forms(card_name)
    print(f"codecs phase {time.time() - t_phase:.1f} s (host library build {build_s:.2f} s) "
          f"[{card_name}]", flush=True)


def _add_launches(record, n):
    record["launches"] = (record["launches"] or 0) + n


def _timed(fn):
    """(fn(), host seconds to the end of the card's work)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def run_dp(data_root, records, card):
    """Phase dp: the round-robin fleet on the e2e pickles.  run_task('davis',
    local_devices=[card] * 2) launches K1 exactly as the single-device run
    and gives its <D exactly; [[card] * 2] * 2 (dp x sp) launches only K4,
    two per frame propagated, and the same <D; two synthetic VOS videos
    through eval_vos on [card] * 2 give the single-device label maps.  Wall
    times beside the single device's (printed, not held); with two cards or
    more (four for dp x sp) the same runs on distinct cards."""
    import torch

    from fgvc_tpu_torch.apis.test import build_tracker, eval_vos, run_task
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    expect = frames_propagated(TapVidDataset(data_root))
    k1.reset_launches()
    single, dt0 = _timed(lambda: run_task("davis", data_root, seed=0, device=card))
    check_launches("dp davis single device", "highest", expect, "banked")
    d0 = single["average_pts_within_thresh"]
    n_cards = torch.cuda.device_count()
    runs = [("[card] * 2", dict(local_devices=[card] * 2), expect, "banked", "K1_circle"),
            ("[[card] * 2] * 2 (dp x sp)", dict(local_devices=[[card] * 2] * 2), 2 * expect,
             "row_block", "K4_circle")]
    if n_cards >= 2:
        runs.append((f"2 distinct cards of {n_cards}", dict(local_devices=2), expect, "banked",
                     "K1_circle"))
    if n_cards >= 4:
        runs.append(("2 groups of 2 distinct cards", dict(local_devices=2, spatial_devices=2),
                     2 * expect, "row_block", "K4_circle"))
    for label, kw, n, entry, key in runs:
        k1.reset_launches()
        (metrics, peak), dt = _timed(lambda: _peak_gb_of(
            lambda: run_task("davis", data_root, seed=0, **kw)))
        check_launches(f"dp davis {label}", "highest", n, entry)
        check_metrics(metrics)
        _add_launches(records[key], n)
        d1 = metrics["average_pts_within_thresh"]
        print(f"dp davis {label}: <D {d1:.6f} vs single device {d0:.6f}; wall {dt:.2f} s vs "
              f"{dt0:.2f} s (model build and data reading included); peak device memory "
              f"{peak:.2f} GB", flush=True)
        if d1 != d0:
            raise AssertionError(f"dp davis {label}: <D {d1} differs from the single device's {d0}")
    vos = SyntheticDavis()
    frames = sum(len(v) - 1 for v in vos.videos)
    tracker = build_tracker(seed=0, device=card)
    fleets = [("[card] * 2", [card] * 2)]
    if n_cards >= 2:
        fleets.append(("2 distinct cards", [torch.device("cuda", i) for i in range(2)]))
    k1.reset_launches()
    res0, dt0 = _timed(lambda: eval_vos(tracker, vos))
    check_launches("dp vos single device", "highest", frames, "banked")
    pred0 = [vos.preds[i] for i in range(len(vos))]
    for label, devices in fleets:
        k1.reset_launches()
        res1, dt1 = _timed(lambda: eval_vos(tracker, vos, devices=devices))
        check_launches(f"dp vos {label}", "highest", frames, "banked")
        _add_launches(records["K1_square"], frames)
        agree = _agreement([vos.preds[i] for i in range(len(vos))], pred0)
        print(f"dp vos {label}, {len(vos)} videos: label maps agree on {100 * agree:.5f}% of "
              f"pixels (must be 100%); J&F-Mean {res1['J&F-Mean']:.6f} vs "
              f"{res0['J&F-Mean']:.6f}; wall {dt1:.2f} s vs {dt0:.2f} s (scoring included)",
              flush=True)
        if agree != 1.0:
            raise AssertionError(f"dp vos {label}: label maps differ from the single device's")


BANK_LONG_T = 250


def run_bank(data_root, card):
    """Phase bank: bank-parallel propagation ('tiled') with `card` listed n
    times.  K1's trajectories of e2e video 0 are taken first; from there on
    K1's counters must stay 0.  Video 0 with bank_devices=[card] * 2 and
    [card] * 3 (uneven shards: 48 frames in 16 and 16, and in 24 and 24)
    against the unsharded 'tiled' run with topk_impl 'certified' (the same tie
    split) and against K1: median |diff| <= 1e-3 px each, <D within 0.1 of
    K1's.  One synthetic VOS video banked on [card] * 2 against the unsharded
    'tiled' run: >= 99.999% of pixels agree.  One 250-frame 256 x 256 video,
    one query group at frame 0, on [card] * 2: each shard's bytes beside the
    whole bank's, the peak device memory and the wall time."""
    import dataclasses

    import torch

    from fgvc_tpu_torch.apis.test import build_tracker, eval_vos
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ds = TapVidDataset(data_root)
    s = ds[0]
    args = (s["video"], s["query_points"])
    k1_out = build_tracker(seed=0, device=card).track_points(*args)
    d_k1 = _score(ds, s, k1_out)["average_pts_within_thresh"]
    k1.reset_launches()
    cfg = dataclasses.replace(DAVIS_TEST_CFG, attention_impl="tiled")
    ref, dt_ref = _timed(lambda: build_tracker(
        dataclasses.replace(cfg, topk_impl="certified"), seed=0, device=card).track_points(*args))
    for n in (2, 3):
        tracker = build_tracker(cfg, seed=0, bank_devices=[card] * n)
        (out, peak), dt = _timed(lambda: _peak_gb_of(lambda: tracker.track_points(*args)))
        d_bank = _score(ds, s, out)["average_pts_within_thresh"]
        for against, other in (("unsharded 'tiled' 'certified'", ref), ("K1", k1_out)):
            diff = np.abs(out["trajectories"] - other["trajectories"])
            med = float(np.median(diff))
            print(f"bank n={n} video 0 vs {against}: median |diff| {med:.3e} px (limit "
                  f"{TRAJ_TOL_PX}), max {diff.max():.3e} px", flush=True)
            if not med <= TRAJ_TOL_PX:
                raise AssertionError(f"bank n={n} vs {against}: median |diff| {med} px")
        print(f"bank n={n} video 0: <D {d_bank:.4f} vs K1 {d_k1:.4f}; {dt:.2f} s vs "
              f"{dt_ref:.2f} s unsharded (features, propagation, decode); peak device memory "
              f"{peak:.2f} GB", flush=True)
        if not abs(d_bank - d_k1) <= DELTA_D_TOL:
            raise AssertionError(f"bank n={n}: <D {d_bank} vs K1 {d_k1}")
        del tracker
    vos = SyntheticDavis(n_videos=1)
    preds = {}
    for label, kw in (("unsharded", dict(device=card)), ("n=2", dict(bank_devices=[card] * 2))):
        res, dt = _timed(lambda: eval_vos(build_tracker(cfg, seed=0, **kw), vos))
        preds[label] = (vos.preds[0], res["J&F-Mean"], dt)
    agree = _agreement([preds["n=2"][0]], [preds["unsharded"][0]])
    print(f"bank vos n=2 vs unsharded 'tiled': label maps agree on {100 * agree:.5f}% of pixels "
          f"(limit {100 * PLAIN_MASK_AGREE:g}%); J&F-Mean {preds['n=2'][1]:.6f} vs "
          f"{preds['unsharded'][1]:.6f}; {preds['n=2'][2]:.2f} s vs {preds['unsharded'][2]:.2f} s "
          "(scoring included)", flush=True)
    if not agree >= PLAIN_MASK_AGREE:
        raise AssertionError(f"bank vos: label maps agree on {agree}")
    # the long video: one query group from frame 0 over 250 frames
    rng = np.random.default_rng(7)
    tex = _texture(rng, 256 + 2 * BANK_LONG_T)
    off = (np.arange(BANK_LONG_T) * 0.7).astype(int) + BANK_LONG_T
    video = np.stack([tex[o:o + 256, o:o + 256] for o in off])
    queries = np.concatenate([np.zeros((32, 1)), rng.uniform(16, 240, (32, 2))], 1)
    tracker = build_tracker(cfg, seed=0, bank_devices=[card] * 2)
    shard_bytes = []
    real = tracker.bank_shards

    def bank_shards(*a, **kw):
        shards, hw = real(*a, **kw)
        shard_bytes.extend(x.numel() * x.element_size() for x in shards)
        return shards, hw

    tracker.bank_shards = bank_shards
    (out, peak), dt = _timed(lambda: _peak_gb_of(
        lambda: tracker.track_points(video, queries.astype(np.float32))))
    finite = bool(np.isfinite(out["trajectories"]).all())
    whole = BANK_LONG_T * shard_bytes[0] / -(-BANK_LONG_T // 2)
    print(f"bank n=2 long video ({BANK_LONG_T} frames at 256 x 256, one group of 32 points): "
          f"shard bytes {[f'{b / 1e9:.3f} GB' for b in shard_bytes]} against "
          f"{whole / 1e9:.3f} GB for the whole bank; peak device memory {peak:.2f} GB (one card "
          f"holds both shards here); {dt:.2f} s, {1e3 * dt / (BANK_LONG_T - 1):.2f} ms per "
          f"propagated frame; trajectories finite {finite}", flush=True)
    if not finite:
        raise AssertionError("bank long video: trajectories not finite")
    check_no_launches("bank phase after K1's reference")


# one rank of phase mp: python -c MP_RANK OUT_DIR ARGS...; the CLI's stdout
# goes to OUT_DIR/rank_<FGVC_PROCESS_ID or single>.txt, then K1's launches
MP_RANK = """
import contextlib, os, sys
from fgvc_tpu_torch.cli.test import main
from fgvc_tpu_torch.ops.cuda import topk_attention as k1
out_dir, argv = sys.argv[1], sys.argv[2:]
rank = os.environ.get("FGVC_PROCESS_ID", "single")
with open(os.path.join(out_dir, f"rank_{rank}.txt"), "w") as f, contextlib.redirect_stdout(f):
    main(argv + ["--output-dir", os.path.join(out_dir, f"out_{rank}")])
    print("K1_LAUNCHES", k1.launches)
"""
MP_TIMEOUT_S = 300


def run_mp(data_root, record):
    """Phase mp: python -m fgvc_tpu_torch.cli.test --task davis on the e2e
    pickles as one process, then as two ranks started by
    python -m fgvc_tpu_torch.cli.launch --nprocs 2 (a gloo group on
    localhost; both ranks on this card): each rank prints metrics equal to
    the single process's, rank 1 writes no output directory, and the ranks'
    K1 launches add up to the single process's; wall times of both."""
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset

    expect = frames_propagated(TapVidDataset(data_root))
    args = ["--task", "davis", "--data-root", data_root]
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mp_") as out:
        for label, prefix in (("one process", []),
                              ("two ranks", ["-m", "fgvc_tpu_torch.cli.launch", "--nprocs", "2",
                                             "--", sys.executable])):
            t0 = time.time()
            proc = subprocess.run([sys.executable, *prefix, "-c", MP_RANK, out, *args], cwd=ROOT,
                                  capture_output=True, text=True, timeout=MP_TIMEOUT_S)
            runs[label] = time.time() - t0
            if proc.returncode != 0:
                raise AssertionError(f"mp {label}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
        results = {}
        for rank in ("single", "0", "1"):
            with open(os.path.join(out, f"rank_{rank}.txt")) as f:
                text = f.read()
            results[rank] = (json.loads(text[text.index("{\n"):text.rindex("}") + 1]),
                             int(text.rsplit("K1_LAUNCHES", 1)[1]))
        wrote = {rank: os.path.isdir(os.path.join(out, f"out_{rank}")) for rank in ("0", "1")}
    launches = [results[r][1] for r in ("single", "0", "1")]
    print(f"mp davis: wall {runs['two ranks']:.2f} s for two ranks on one card against "
          f"{runs['one process']:.2f} s for one process (process start, model build and data "
          f"reading included); K1 launches single {launches[0]}, rank 0 {launches[1]}, rank 1 "
          f"{launches[2]}; output directory written by rank 0 {wrote['0']}, rank 1 "
          f"{wrote['1']}", flush=True)
    for rank in ("0", "1"):
        if results[rank][0] != results["single"][0]:
            raise AssertionError(f"mp rank {rank}: metrics {results[rank][0]} differ from one "
                                 f"process's {results['single'][0]}")
    if launches[0] != expect or launches[1] + launches[2] != expect:
        raise AssertionError(f"mp: K1 launches {launches}, expected {expect} in all")
    if not wrote["0"] or wrote["1"]:
        raise AssertionError(f"mp: output directories written {wrote}; only rank 0 writes")
    _add_launches(record, launches[1] + launches[2])
    print(f"mp davis: both ranks' metrics equal one process's: <D "
          f"{results['single'][0]['average_pts_within_thresh']:.6f}", flush=True)

TRAIN_STEPS = 8           # full-width steps of phase train (a)
TRAIN_PROFILED = 3        # steps under torch.profiler
TRAIN_LOSS_RTOL = 1e-4    # (b) card against CPU, 'highest'
TRAIN_GRAD_RTOL = 1e-3    # (b) relative L2 per gradient leaf
TRAIN_RESUME_TOL = 1e-4   # (c) largest parameter difference
SMALL_TRAIN = dict(crop_size=64, radius=4, batch_size=2, matmul_precision="highest")
BF16_LOSS_SHARE = 0.01    # (e) bfloat16 losses at init against float32's (tests/test_train.py:560)


def _train_model(cfg, steps, work_dir, **kw):
    """fgvc_tpu_torch.apis.train.train_model on structured data, as
    python -m fgvc_tpu_torch.cli.train --synthetic-mode structured runs it."""
    from fgvc_tpu_torch.apis.train import train_model
    from fgvc_tpu_torch.datasets.flyingthings_ytv import (StructuredSyntheticMixedDataset,
                                                          make_batches)

    ds = StructuredSyntheticMixedDataset(crop=cfg.crop_size, seed=cfg.seed)
    skip = kw.pop("skip", 0)
    return train_model(cfg, make_batches(ds, cfg.batch_size, steps, skip=skip), work_dir,
                       steps_per_epoch=16, max_steps=steps, device="cuda", **kw)


def _read_log(work_dir):
    with open(os.path.join(work_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_train_full_width(work_dir):
    """(a) The TrainConfig defaults (crop 256, batch 4, radius 24, 'high',
    all three branches) for TRAIN_STEPS steps through train_model: finite
    losses, the median step ms from step 3 on, peak device memory; then
    TRAIN_PROFILED more steps under torch.profiler: busy share, top kernels."""
    import torch

    from fgvc_tpu_torch.config import TrainConfig
    from fgvc_tpu_torch.core.train import step_generator
    from fgvc_tpu_torch.datasets.flyingthings_ytv import (StructuredSyntheticMixedDataset,
                                                          make_batches)

    cfg = TrainConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    trainer = _train_model(cfg, TRAIN_STEPS, work_dir, log_interval=1,
                           ckpt_interval=TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    logs = [r for r in _read_log(work_dir) if "loss" in r]
    if len(logs) != TRAIN_STEPS:
        raise AssertionError(f"train (a): {len(logs)} logged steps, expected {TRAIN_STEPS}")
    for r in logs:
        bad = [k for k in ("l1_loss", "sup_loss", "corr_da_loss", "loss") if not np.isfinite(r[k])]
        if bad:
            raise AssertionError(f"train (a): non-finite {bad} at step {r['step']}")
    step_ms = [1e3 / r["steps_per_sec"] for r in logs[2:]]
    print(f"train (a) full width (crop {cfg.crop_size}, batch {cfg.batch_size}, radius "
          f"{cfg.radius}, '{cfg.matmul_precision}', ResNet-18-d1): {TRAIN_STEPS} steps in "
          f"{wall:.1f} s (first steps include cuDNN's search); step ms from step 3 "
          f"{[round(x, 1) for x in step_ms]}, median {float(np.median(step_ms)):.1f} ms; "
          f"peak device memory {peak:.2f} GB", flush=True)
    print("train (a) losses: " + json.dumps({k: logs[-1][k] for k in
                                             ("l1_loss", "sup_loss", "corr_da_loss", "loss")}))
    ds = StructuredSyntheticMixedDataset(crop=cfg.crop_size, seed=cfg.seed + 1)
    batches = [trainer.to_device(b) for b in
               make_batches(ds, cfg.batch_size, TRAIN_PROFILED)]

    def steps():
        for b in batches:
            trainer.train_step(b, step_generator(cfg.seed, trainer.step))

    by_kernel, wall_ms = device_ms_by_kernel(steps)
    busy = sum(by_kernel.values())
    if busy:
        print(f"train (a) {TRAIN_PROFILED} profiled steps (batches on the card): wall "
              f"{wall_ms:.1f} ms ({wall_ms / TRAIN_PROFILED:.1f} per step), device busy "
              f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%); top kernels: "
              + _top(by_kernel, 8), flush=True)
    else:
        print("train (a) profile: device time not measured by torch.profiler")
    del trainer, batches
    torch.cuda.empty_cache()
    return float(np.median(step_ms)), peak


def _leaf_errors(a, b):
    """{name: relative L2 of a's gradient against b's} over a's modules."""
    out = {}
    for name, module in a.trainable().items():
        other = dict(b.trainable()[name].named_parameters())
        for pname, p in module.named_parameters():
            q = other[pname]
            if p.grad is None and q.grad is None:
                continue
            ref = q.grad.double().cpu()
            out[f"{name}.{pname}"] = float((p.grad.double().cpu() - ref).norm()
                                           / ref.norm().clamp_min(1e-30))
    return out


def run_train_card_vs_cpu():
    """(b) One loss_fn + backward at crop 64, radius 4, 'highest' on the card
    and on the CPU from the same weights, batch and dropped channels; each
    also against the CPU in float64 (printed: BN-bias gradients are sums
    that cancel, and float32 keeps a few 1e-3 of them)."""
    import torch

    from fgvc_tpu_torch.config import TrainConfig
    from fgvc_tpu_torch.core.train import MixedTrainer
    from fgvc_tpu_torch.datasets.flyingthings_ytv import (StructuredSyntheticMixedDataset,
                                                          make_batches)

    cfg = TrainConfig(**SMALL_TRAIN)
    cpu = MixedTrainer(cfg, device="cpu").init(0, 16)
    card = MixedTrainer(cfg, device="cuda")
    card.load_module_states({k: m.state_dict() for k, m in
                             {**cpu.trainable(), "teacher": cpu.teacher}.items()})
    card.reset_optimizer(16)
    batch = next(make_batches(StructuredSyntheticMixedDataset(crop=cfg.crop_size, seed=5),
                              cfg.batch_size, 1))
    # float64 on the CPU: how far float32 itself is from the gradients
    exact = MixedTrainer(cfg, device="cpu")
    exact.load_module_states({k: m.state_dict() for k, m in
                              {**cpu.trainable(), "teacher": cpu.teacher}.items()})
    for m in (*exact.trainable().values(), exact.teacher):
        m.double()
    losses = {}
    for name, trainer in (("cpu", cpu), ("card", card), ("float64", exact)):
        b = {k: torch.as_tensor(v).to(trainer.device, next(trainer.backbone.parameters()).dtype)
             for k, v in batch.items()}
        total, parts = trainer.loss_fn(b, (1, 2))
        total.backward()
        losses[name] = {k: float(v.detach()) for k, v in parts.items()}
    errs = _leaf_errors(card, cpu)
    worst = max(errs, key=errs.get)
    loss_err = max(abs(losses["card"][k] - v) / abs(v) for k, v in losses["cpu"].items())
    to_f64 = {name: max(_leaf_errors(t, exact).values()) for name, t in (("card", card),
                                                                          ("cpu", cpu))}
    print(f"train (b) card vs CPU (crop 64, radius 4, 'highest'): losses {losses['card']}, "
          f"largest relative loss difference {loss_err:.2e}; {len(errs)} gradient leaves, "
          f"worst {worst} at {errs[worst]:.2e} relative L2 (worst leaf against float64: "
          f"card {to_f64['card']:.2e}, CPU {to_f64['cpu']:.2e})", flush=True)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"train (b): losses differ by {loss_err} relative")
    if not errs[worst] <= TRAIN_GRAD_RTOL:
        raise AssertionError(f"train (b): gradient {worst} differs by {errs[worst]}")


def run_train_resume(root):
    """(c) 2 steps, a checkpoint, 2 resumed steps against 4 straight steps on
    the card (crop 64, radius 4): the largest parameter difference."""
    import torch

    from fgvc_tpu_torch.config import TrainConfig

    cfg = TrainConfig(**SMALL_TRAIN)
    a = _train_model(cfg, 4, os.path.join(root, "a"), ckpt_interval=100, resume=False)
    _train_model(cfg, 2, os.path.join(root, "b"), ckpt_interval=2, resume=False)
    b = _train_model(cfg, 4, os.path.join(root, "b"), ckpt_interval=100, resume=True, skip=2)
    diff = 0.0
    for name, module in a.trainable().items():
        for (k, v), w in zip(module.state_dict().items(),
                             b.trainable()[name].state_dict().values()):
            if v.is_floating_point():
                diff = max(diff, float((v - w).abs().max()))
    print(f"train (c) 2 + resume + 2 against 4 steps on the card: steps {a.step}, {b.step}; "
          f"largest parameter/statistic difference {diff:.3e}", flush=True)
    if a.step != 4 or b.step != 4 or not diff <= TRAIN_RESUME_TOL:
        raise AssertionError(f"train (c): resumed run differs by {diff}")
    torch.cuda.empty_cache()
    return b


def run_train_val(trainer, root):
    """(d) make_synthetic_val_fn on the student: mid-training validation
    through the port's Tracker launches K1 on the card."""
    from fgvc_tpu_torch.apis.train import make_synthetic_val_fn
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    val_fn = make_synthetic_val_fn(root, device="cuda")
    k1.reset_launches()
    metrics = val_fn(trainer)
    launches = (k1.launches, k1.unbanked_launches, k1.row_block_launches)
    print(f"train (d) mid-training validation: K1 launches {launches[0]} (K2 {launches[1]}, "
          f"K4 {launches[2]}); " + json.dumps({k: metrics[k] for k in
                                               ("average_pts_within_thresh", "average_jaccard")}),
          flush=True)
    check_metrics(metrics)
    if not launches[0] > 0:
        raise AssertionError("train (d): the validation launched no K1")


def _float32_state(trainer):
    """Names of the parameters, buffers and Adam moments that are not
    float32."""
    import torch

    bad = [name for module in (*trainer.trainable().values(), trainer.teacher)
           for name, t in (*module.named_parameters(), *module.named_buffers())
           if t.is_floating_point() and t.dtype != torch.float32]
    bad += [k for state in trainer.optimizer.adam.state.values() for k, v in state.items()
            if torch.is_tensor(v) and v.is_floating_point() and v.dtype != torch.float32]
    return bad


def run_train_bf16(work_dir, f32_step_ms, f32_peak):
    """(e) compute_dtype 'bfloat16' at full width: one loss_fn from the same
    init, batch and dropped channels in float32 and in bfloat16 (the
    losses within BF16_LOSS_SHARE of each other); then TRAIN_STEPS steps
    through train_model (median step ms from step 3, peak memory) with
    parameters, statistics and Adam's moments float32 after them, and
    TRAIN_PROFILED steps under torch.profiler (busy share, top kernels)."""
    import dataclasses

    import torch

    from fgvc_tpu_torch.config import TrainConfig
    from fgvc_tpu_torch.core.train import MixedTrainer, step_generator
    from fgvc_tpu_torch.datasets.flyingthings_ytv import (StructuredSyntheticMixedDataset,
                                                          make_batches)

    cfg = dataclasses.replace(TrainConfig(), compute_dtype="bfloat16")
    batch = next(make_batches(StructuredSyntheticMixedDataset(crop=cfg.crop_size, seed=3),
                              cfg.batch_size, 1))
    losses = {}
    for dtype in ("float32", "bfloat16"):
        trainer = MixedTrainer(dataclasses.replace(cfg, compute_dtype=dtype), "cuda").init(0, 16)
        with torch.no_grad():
            _, parts = trainer.loss_fn(trainer.to_device(batch), (1, 2))
        losses[dtype] = {k: float(v) for k, v in parts.items()}
        del trainer
    share = max(abs(losses["bfloat16"][k] - v) / abs(v) for k, v in losses["float32"].items())
    print(f"train (e) bfloat16 at init against float32 (full width, same weights, batch and "
          f"channels): bfloat16 {losses['bfloat16']}, float32 {losses['float32']}; largest "
          f"relative difference {share:.2e}", flush=True)
    if not share <= BF16_LOSS_SHARE:
        raise AssertionError(f"train (e): bfloat16 losses {share:.2e} from float32's")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = _train_model(cfg, TRAIN_STEPS, work_dir, log_interval=1, ckpt_interval=TRAIN_STEPS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    logs = [r for r in _read_log(work_dir) if "loss" in r]
    if len(logs) != TRAIN_STEPS or not all(np.isfinite(r["loss"]) for r in logs):
        raise AssertionError(f"train (e): {len(logs)} logged steps or non-finite losses")
    bad = _float32_state(trainer)
    if bad:
        raise AssertionError(f"train (e): state not float32: {bad[:5]}")
    step_ms = [1e3 / r["steps_per_sec"] for r in logs[2:]]
    med = float(np.median(step_ms))
    f32 = f"{f32_step_ms:.1f} ms and {f32_peak:.2f} GB" if f32_step_ms else "not measured"
    print(f"train (e) bfloat16 full width: step ms from step 3 {[round(x, 1) for x in step_ms]}, "
          f"median {med:.1f} ms; peak device memory {peak:.2f} GB (float32, (a): {f32}); "
          f"parameters, statistics and Adam moments float32", flush=True)
    ds = StructuredSyntheticMixedDataset(crop=cfg.crop_size, seed=cfg.seed + 1)
    batches = [trainer.to_device(b) for b in make_batches(ds, cfg.batch_size, TRAIN_PROFILED)]

    def steps():
        for b in batches:
            trainer.train_step(b, step_generator(cfg.seed, trainer.step))

    by_kernel, wall_ms = device_ms_by_kernel(steps)
    busy = sum(by_kernel.values())
    if busy:
        print(f"train (e) bfloat16 {TRAIN_PROFILED} profiled steps: wall {wall_ms:.1f} ms "
              f"({wall_ms / TRAIN_PROFILED:.1f} per step), device busy {busy:.1f} ms "
              f"({100 * busy / wall_ms:.1f}%); top kernels: " + _top(by_kernel, 6), flush=True)
    else:
        print("train (e) profile: device time not measured by torch.profiler")
    del trainer, batches
    torch.cuda.empty_cache()


def run_train():
    """Phase train: (a) full width, (b) card against CPU, (c) resume, (d)
    mid-training validation through K1, (e) bfloat16.  Returns (a)'s median
    step ms."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        t0 = time.time()
        step_ms, peak = run_train_full_width(os.path.join(root, "full"))
        run_train_card_vs_cpu()
        trainer = run_train_resume(root)
        run_train_val(trainer, root)
        del trainer
        run_train_bf16(os.path.join(root, "bf16"), step_ms, peak)
        print(f"train phase {time.time() - t0:.1f} s", flush=True)
    return step_ms


# --------------------------------------------------------------------- #
# realtrain: FlyingThingsYtvDataset through the training CLI
# --------------------------------------------------------------------- #
RT_YTV_VIDEOS, RT_YTV_FRAMES, RT_YTV_HW = 8, 6, (256, 455)
RT_FT_SCENES, RT_FT_FRAMES, RT_FT_HW = 2, 5, (540, 960)
RT_SAMPLES = 20           # (a) samples timed, one at a time
RT_BATCHES = 5            # (a) batches of the TrainConfig's size timed


def write_pfm(path, flow):
    """(H, W, 3) float32 as FlyingThings3D writes it: 'PF', a negative
    (little-endian) scale, rows bottom-up."""
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(f"PF\n{w} {h}\n-1.0\n".encode()
                + np.ascontiguousarray(flow[::-1], "<f4").tobytes())


def make_real_trees(root):
    """Phase realtrain's trees from integer-made frames: YouTube-VOS JPEGs
    (the port's encoder, quality 95) with a --ytv-list of every other frame,
    FlyingThings3D PNGs with flows in hundredths of a pixel up to 30 px.
    Returns (ytv_root, flyingthings_root, ytv_list)."""
    from fgvc_tpu_torch.data_io.fgpack import encode_jpeg

    ytv, ft = os.path.join(root, "ytv"), os.path.join(root, "flyingthings")
    listing = {}
    for v in range(RT_YTV_VIDEOS):
        vid = f"video{v:02d}"
        d = os.path.join(ytv, "train", "JPEGImages_s256", vid)
        os.makedirs(d)
        names = [f"{5 * t:05d}.jpg" for t in range(RT_YTV_FRAMES)]
        for t, name in enumerate(names):
            with open(os.path.join(d, name), "wb") as f:
                f.write(encode_jpeg(codec_pin_frame(*RT_YTV_HW, seed=1000 + 10 * v + t), 95))
        listing[vid] = names[::2]
    list_path = os.path.join(root, "ytv_list.json")
    with open(list_path, "w") as f:
        json.dump(listing, f)
    rng = np.random.default_rng(0)
    for sc in range(RT_FT_SCENES):
        scene = os.path.join("A", f"{sc:04d}")
        img_dir = os.path.join(ft, "frames_cleanpass", "TRAIN", scene, "left")
        flow_dirs = {tag: os.path.join(ft, "optical_flow", "TRAIN", scene, sub, "left")
                     for tag, sub in (("IntoFuture", "into_future"), ("IntoPast", "into_past"))}
        for d in (img_dir, *flow_dirs.values()):
            os.makedirs(d)
        for n in range(6, 6 + RT_FT_FRAMES):
            encode_png(os.path.join(img_dir, f"{n:04d}.png"),
                       codec_pin_frame(*RT_FT_HW, seed=2000 + 10 * sc + n))
            for tag, d in flow_dirs.items():
                flow = (rng.integers(-3000, 3001, (*RT_FT_HW, 3)) / 100).astype(np.float32)
                write_pfm(os.path.join(d, f"OpticalFlow{tag}_{n:04d}_L.pfm"), flow)
    return ytv, ft, list_path


# (a)'s split: the dataset module's functions timed, by what they do
_RT_STAGES = {"read_flow_pfm": "PFM read", "resize_frames": "crop and resize",
              "gaussian_blur": "blur", "rgb_to_lab_normalized": "Lab"}
RT_WEBP_FIXTURE = "lossy_q90_540x960.webp"   # (d) every FlyingThings frame of the WebP tree
RT_WEBP_STEPS = 4                            # (d) cli.train steps on it


def _decode_stage(args):
    path = str(args[0])
    if path.endswith(".jpg"):
        return "YouTube-VOS decode"
    return "WebP decode" if path.endswith(".webp") else "PNG decode"


def make_webp_tree(root, trees):
    """The FlyingThings3D tree again with its cleanpass frames as WebP (the
    published form beside PNG): each frame the committed 540 x 960 lossy
    fixture (the card's machine has no WebP encoder), the flows those of the
    PNG tree.  Returns (ytv_root, flyingthings_root, ytv_list)."""
    ytv, ft, list_path = trees
    webp_ft = os.path.join(root, "flyingthings_webp")
    with open(os.path.join(ROOT, FIXTURE_DIR, RT_WEBP_FIXTURE), "rb") as f:
        frame = f.read()
    for png in sorted(glob.glob(os.path.join(ft, "frames_cleanpass", "TRAIN", "*", "*", "left",
                                             "*.png"))):
        rel = os.path.relpath(png, ft)
        dst = os.path.join(webp_ft, rel[:-4] + ".webp")
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(dst, "wb") as f:
            f.write(frame)
    os.symlink(os.path.join(ft, "optical_flow"), os.path.join(webp_ft, "optical_flow"))
    return ytv, webp_ft, list_path


def run_realtrain_webp_cli(trees, work_dir, synth_step_ms, card_name):
    """(d) python -m fgvc_tpu_torch.cli.train on the WebP tree with the
    TrainConfig defaults for RT_WEBP_STEPS steps: finite losses, step ms."""
    from fgvc_tpu_torch.cli import train as cli_train

    ytv, ft, list_path = trees
    t0 = time.time()
    rc = cli_train.main(["--ytv-root", ytv, "--flyingthings-root", ft, "--ytv-list", list_path,
                         "--max-steps", str(RT_WEBP_STEPS), "--log-interval", "1",
                         "--ckpt-interval", str(RT_WEBP_STEPS), "--work-dir", work_dir])
    logs = [r for r in _read_log(work_dir) if "loss" in r]
    if rc != 0 or len(logs) != RT_WEBP_STEPS or not all(np.isfinite(r["loss"]) for r in logs):
        raise AssertionError(f"realtrain (d): exit {rc}, {len(logs)} logged steps or "
                             "non-finite losses")
    step_ms = [1e3 / r["steps_per_sec"] for r in logs[2:]]
    synth = f"{synth_step_ms:.1f} ms" if synth_step_ms else "not measured"
    print(f"realtrain (d) cli.train on the WebP cleanpass tree ({card_name}): "
          f"{RT_WEBP_STEPS} steps in {time.time() - t0:.1f} s; step ms from step 3 "
          f"{[round(x, 1) for x in step_ms]} (synthetic {synth}); losses "
          + json.dumps({k: logs[-1][k] for k in ("l1_loss", "sup_loss", "corr_da_loss", "loss")}),
          flush=True)


def run_realtrain_reader(trees, card_name):
    """(a) The host ms of a sample split by stage (the dataset module's
    read_image, read_flow_pfm, resize_frames, gaussian_blur and
    rgb_to_lab_normalized wrapped in timers), the median of RT_SAMPLES; then
    the ms of a batch of the TrainConfig's size (make_batches, no timers).
    Returns the median batch ms."""
    from fgvc_tpu_torch.config import TrainConfig
    from fgvc_tpu_torch.datasets import flyingthings_ytv as ds_mod

    cfg = TrainConfig()
    ds = ds_mod.FlyingThingsYtvDataset(*trees[:2], ytv_list=trees[2], crop=cfg.crop_size,
                                       seed=cfg.seed)
    spent = {}

    def timer(fn, stage_of):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            stage = stage_of(args)
            spent[stage] = spent.get(stage, 0.0) + time.perf_counter() - t0
            return out
        return wrapped

    saved = {name: getattr(ds_mod, name) for name in ("read_image", *_RT_STAGES)}
    per_sample = []
    try:
        ds_mod.read_image = timer(saved["read_image"], _decode_stage)
        for name, stage in _RT_STAGES.items():
            setattr(ds_mod, name, timer(saved[name], lambda a, stage=stage: stage))
        for i in range(RT_SAMPLES):
            spent.clear()
            t0 = time.perf_counter()
            ds[i]
            total = time.perf_counter() - t0
            per_sample.append({**spent, "rest": total - sum(spent.values()), "total": total})
    finally:
        for name, fn in saved.items():
            setattr(ds_mod, name, fn)
    frames = "WebP decode" if trees[1].endswith("webp") else "PNG decode"
    stages = ("YouTube-VOS decode", frames, *_RT_STAGES.values(), "rest", "total")
    med = {k: 1e3 * float(np.median([p.get(k, 0.0) for p in per_sample])) for k in stages}
    batches = ds_mod.make_batches(ds, cfg.batch_size, RT_BATCHES)
    batch_ms = []
    for _ in range(RT_BATCHES):
        t0 = time.perf_counter()
        next(batches)
        batch_ms.append(1e3 * (time.perf_counter() - t0))
    print(f"realtrain (a) host ms a sample (crop {cfg.crop_size}; {card_name}; median of "
          f"{RT_SAMPLES}, one thread): " + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
          + f"; a batch of {cfg.batch_size}: median {float(np.median(batch_ms)):.1f} ms "
          f"({[round(x, 1) for x in batch_ms]})", flush=True)
    return float(np.median(batch_ms))


def run_realtrain_cli(trees, work_dir, record, synth_step_ms, batch_ms, card_name):
    """(b) python -m fgvc_tpu_torch.cli.train on the trees with the
    TrainConfig defaults (in this process, so K1's counters see the
    validation) for TRAIN_STEPS steps and --synthetic-val; then
    TRAIN_PROFILED steps with the reader in the loop (make_batches on
    prefetch_iter's thread, as train_model reads) under torch.profiler."""
    import torch

    from fgvc_tpu_torch.cli import train as cli_train
    from fgvc_tpu_torch.config import TrainConfig
    from fgvc_tpu_torch.core.train import MixedTrainer, step_generator
    from fgvc_tpu_torch.data_io.prefetch import prefetch_iter
    from fgvc_tpu_torch.datasets import flyingthings_ytv as ds_mod
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ytv, ft, list_path = trees
    k1.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    rc = cli_train.main(["--ytv-root", ytv, "--flyingthings-root", ft, "--ytv-list", list_path,
                         "--max-steps", str(TRAIN_STEPS), "--log-interval", "1",
                         "--ckpt-interval", str(TRAIN_STEPS), "--synthetic-val",
                         "--val-interval", str(TRAIN_STEPS), "--work-dir", work_dir])
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = (k1.launches, k1.unbanked_launches, k1.row_block_launches)
    lines = _read_log(work_dir)
    logs = [r for r in lines if "loss" in r]
    vals = [r["val"] for r in lines if "val" in r]
    if rc != 0 or len(logs) != TRAIN_STEPS or len(vals) != 1:
        raise AssertionError(f"realtrain (b): exit {rc}, {len(logs)} logged steps, "
                             f"{len(vals)} validations")
    for r in logs:
        bad = [k for k in ("l1_loss", "sup_loss", "corr_da_loss", "loss") if not np.isfinite(r[k])]
        if bad:
            raise AssertionError(f"realtrain (b): non-finite {bad} at step {r['step']}")
    check_metrics(vals[0])
    if not launches[0] > 0 or launches[1] or launches[2]:
        raise AssertionError(f"realtrain (b): validation launches (K1, K2, K4) {launches}")
    _add_launches(record, launches[0])
    step_ms = [1e3 / r["steps_per_sec"] for r in logs[2:]]
    med = float(np.median(step_ms))
    synth = f"{synth_step_ms:.1f} ms" if synth_step_ms else "not measured (phase train not run)"
    print(f"realtrain (b) cli.train --ytv-root --flyingthings-root --ytv-list (TrainConfig "
          f"defaults, {card_name}): {TRAIN_STEPS} steps in {wall:.1f} s (model build, cuDNN's "
          f"search, checkpoint and validation included); step ms from step 3 "
          f"{[round(x, 1) for x in step_ms]}, median {med:.1f} against phase train's synthetic "
          f"{synth}; the reader's batch {batch_ms:.1f} ms; peak device memory {peak:.2f} GB; "
          f"validation K1 launches {launches[0]}: " + json.dumps(
              {k: vals[0][k] for k in ("average_pts_within_thresh", "average_jaccard")}),
          flush=True)
    print("realtrain (b) losses: " + json.dumps({k: logs[-1][k] for k in
                                                 ("l1_loss", "sup_loss", "corr_da_loss", "loss")}))
    cfg = TrainConfig()
    ds = ds_mod.FlyingThingsYtvDataset(ytv, ft, ytv_list=list_path, crop=cfg.crop_size,
                                       seed=cfg.seed)
    trainer = MixedTrainer(cfg, "cuda").init(cfg.seed, 16)
    batches = prefetch_iter(ds_mod.make_batches(ds, cfg.batch_size, 1 + TRAIN_PROFILED), depth=2)
    trainer.train_step(next(batches), step_generator(cfg.seed, 0))  # outside the trace

    def steps():
        for b in batches:
            trainer.train_step(b, step_generator(cfg.seed, trainer.step))

    by_kernel, wall_ms = device_ms_by_kernel(steps)
    busy = sum(by_kernel.values())
    if busy:
        print(f"realtrain (b) {TRAIN_PROFILED} profiled steps, the reader in the loop: wall "
              f"{wall_ms:.1f} ms ({wall_ms / TRAIN_PROFILED:.1f} per step), device busy "
              f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%); top kernels: "
              + _top(by_kernel, 6), flush=True)
    else:
        print("realtrain (b) profile: device time not measured by torch.profiler")
    del trainer
    torch.cuda.empty_cache()
    return med


def run_realtrain_resume(trees, root):
    """(c) At crop 64, radius 4, batch 2, 'highest' on the trees: 2 steps, a
    checkpoint, 2 resumed steps against 4 straight steps on the card (the
    largest parameter difference), and make_batches(skip=2) equal to the
    last two batches of the full stream."""
    import torch

    from fgvc_tpu_torch.apis.train import train_model
    from fgvc_tpu_torch.config import TrainConfig
    from fgvc_tpu_torch.datasets import flyingthings_ytv as ds_mod

    cfg = TrainConfig(**SMALL_TRAIN)
    ds = ds_mod.FlyingThingsYtvDataset(*trees[:2], ytv_list=trees[2], crop=cfg.crop_size,
                                       seed=cfg.seed)

    def run(name, steps, skip, **kw):
        return train_model(cfg, ds_mod.make_batches(ds, cfg.batch_size, steps, skip=skip),
                           os.path.join(root, name), steps_per_epoch=16, max_steps=steps,
                           device="cuda", **kw)

    a = run("a", 4, 0, ckpt_interval=100, resume=False)
    run("b", 2, 0, ckpt_interval=2, resume=False)
    b = run("b", 4, 2, ckpt_interval=100, resume=True)
    diff = 0.0
    for name, module in a.trainable().items():
        for v, w in zip(module.state_dict().values(), b.trainable()[name].state_dict().values()):
            if v.is_floating_point():
                diff = max(diff, float((v - w).abs().max()))
    full = list(ds_mod.make_batches(ds, cfg.batch_size, 4))
    tail = list(ds_mod.make_batches(ds, cfg.batch_size, 4, skip=2))
    same = len(tail) == 2 and all(np.array_equal(x[k], y[k])
                                  for x, y in zip(full[2:], tail) for k in x)
    print(f"realtrain (c) 2 + resume + 2 against 4 steps on the card (crop 64): steps {a.step}, "
          f"{b.step}; largest parameter/statistic difference {diff:.3e}; the resumed run's "
          f"batches {'equal' if same else 'DIFFERENT'}", flush=True)
    if a.step != 4 or b.step != 4 or not diff <= TRAIN_RESUME_TOL or not same:
        raise AssertionError(f"realtrain (c): resumed run differs by {diff}, batches equal {same}")
    torch.cuda.empty_cache()


def run_realtrain(record, synth_step_ms, card_name):
    """Phase realtrain (see the module's docstring)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_realtrain_") as root:
        t0 = time.time()
        trees = make_real_trees(os.path.join(root, "data"))
        print(f"realtrain: trees written in {time.time() - t0:.2f} s", flush=True)
        batch_ms = run_realtrain_reader(trees, card_name)
        run_realtrain_cli(trees, os.path.join(root, "run"), record, synth_step_ms, batch_ms,
                          card_name)
        run_realtrain_resume(trees, root)
        webp_trees = make_webp_tree(os.path.join(root, "data"), trees)
        run_realtrain_reader(webp_trees, card_name)
        run_realtrain_webp_cli(webp_trees, os.path.join(root, "run_webp"), synth_step_ms,
                               card_name)
        print(f"realtrain phase {time.time() - t0:.1f} s [{card_name}]", flush=True)


# --------------------------------------------------------------------- #
# ddp: data-parallel training, two ranks on this card
# --------------------------------------------------------------------- #
DDP_STEPS = 5             # steps of each run, validation at the last
DDP_LOSS_RTOL = 1e-4      # step 1 (before any update): two ranks against one process
DDP_LATER_RTOL = 3e-3     # steps 2..DDP_STEPS: two ranks against one process
DDP_TIMEOUT_S = 300
# a rank of the training CLI that prints its K1 launches (the validation's)
# and the sha256 of its trained state (parameters and BatchNorm buffers)
DDP_RANK = """
import hashlib, os, sys
import torch
from fgvc_tpu_torch.apis import train as api
from fgvc_tpu_torch.cli.train import main
from fgvc_tpu_torch.ops.cuda import topk_attention as k1
train_model = api.train_model
def hashed(*a, **kw):
    trainer = train_model(*a, **kw)
    h = hashlib.sha256()
    for name, module in sorted(trainer.trainable().items()):
        for v in module.state_dict().values():
            h.update(v.detach().reshape(-1).cpu().view(torch.uint8).numpy().tobytes())
    print("STATE_SHA256", os.environ.get("FGVC_PROCESS_ID"), h.hexdigest(), flush=True)
    return trainer
api.train_model = hashed
rc = main(sys.argv[1:])
print("K1_LAUNCHES", os.environ.get("FGVC_PROCESS_ID"), k1.launches, flush=True)
sys.exit(rc)
"""


def _ddp_args(work_dir):
    return ["--synthetic", "--synthetic-mode", "structured", "--batch-size", "4",
            "--max-steps", str(DDP_STEPS), "--log-interval", "1",
            "--ckpt-interval", str(DDP_STEPS), "--synthetic-val",
            "--val-interval", str(DDP_STEPS), "--work-dir", work_dir]


def _launch_ddp(work_dir):
    # two runs of two ranks share the host's cores beside this process
    return subprocess.Popen([sys.executable, "-m", "fgvc_tpu_torch.cli.launch", "--nprocs", "2",
                             "--", sys.executable, "-c", DDP_RANK, *_ddp_args(work_dir)],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=dict(os.environ, OMP_NUM_THREADS="2"))


def _ddp_finish(proc, label):
    try:
        out, _ = proc.communicate(timeout=DDP_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    if proc.returncode != 0:
        raise AssertionError(f"ddp {label}: exit {proc.returncode}\n{out[-3000:]}")
    return out


# the ranks share one pipe, so a print of one may land inside a line of the
# other: what a rank reports is found anywhere in the output, not by lines
def _k1_by_rank(out):
    return {int(r): int(n) for r, n in re.findall(r"K1_LAUNCHES (\d+) (\d+)", out)}


def _state_by_rank(out):
    """{rank: digest of its trained state} from the STATE_SHA256 reports."""
    return {int(r): d for r, d in re.findall(r"STATE_SHA256 (\d+) ([0-9a-f]{64})", out)}


def run_ddp(record, card_name):
    """Phase ddp: python -m fgvc_tpu_torch.cli.launch --nprocs 2 running
    python -m fgvc_tpu_torch.cli.train --synthetic at full width (the
    TrainConfig defaults, global batch 4, two per rank) on this card over
    gloo, against one process: step 1's logged losses (before any update)
    within DDP_LOSS_RTOL, the later steps' within DDP_LATER_RTOL (Adam's
    first update is lr * sign(g), so rounding moves later losses); the two
    ranks' trained states bit-equal in every two-rank run; validation on
    rank 0 alone (K1).  Then a SIGTERM to a launcher after step 1 while an
    uninterrupted twin runs beside it: both ranks stop at one step with a
    checkpoint, the restarted command resumes there, the log reads exactly
    1..DDP_STEPS, and its losses are compared with the twin's."""
    import signal

    from fgvc_tpu_torch.cli import train as cli_train
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    keys = ("l1_loss", "sup_loss", "corr_da_loss", "loss")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_") as root:
        one, main_dir, twin_dir = (os.path.join(root, d) for d in ("one", "main", "twin"))
        k1.reset_launches()
        t0 = time.time()
        if cli_train.main(_ddp_args(one)) != 0:
            raise AssertionError("ddp: the one-process run failed")
        one_s, one_k1 = time.time() - t0, k1.launches
        t0 = time.time()
        twin = _launch_ddp(twin_dir)
        main = _launch_ddp(main_dir)
        while not [r for r in _maybe_log(main_dir) if "loss" in r] and main.poll() is None \
                and time.time() - t0 < DDP_TIMEOUT_S:
            time.sleep(0.05)
        main.send_signal(signal.SIGTERM)
        out1 = _ddp_finish(main, "preempted run")
        out_twin = _ddp_finish(twin, "twin")
        twin_s = time.time() - t0
        stops = [int(k) for k in re.findall(r"preempted: stopping at step (\d+)", out1)]
        if len(stops) != 2 or stops[0] != stops[1] or not 1 <= stops[0] < DDP_STEPS:
            raise AssertionError(f"ddp: stop steps {stops}\n{out1[-2000:]}")
        backends = sorted(set(re.findall(r"rank \d+ of \d+ on \S+, backend (gloo|nccl)", out_twin)))
        t1 = time.time()
        out2 = _ddp_finish(_launch_ddp(main_dir), "resumed run")
        resume_s = time.time() - t1
        if f"(step {stops[0]})" not in out2:
            raise AssertionError(f"ddp: the restart did not resume at {stops[0]}")
        logs = {name: [r for r in _read_log(d) if "loss" in r]
                for name, d in (("one", one), ("twin", twin_dir), ("main", main_dir))}
        steps = [r["step"] for r in logs["main"]]
        if steps != list(range(1, DDP_STEPS + 1)):
            raise AssertionError(f"ddp: the resumed log reads steps {steps}")
        rel = [max(abs(a[k] - b[k]) / abs(b[k]) for k in keys)
               for a, b in zip(logs["twin"], logs["one"])]
        resumed = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(logs["main"], logs["twin"])
                      for k in keys)
        k1_ranks = {**_k1_by_rank(out_twin)}
        states = {label: _state_by_rank(out) for label, out in
                  (("twin", out_twin), ("preempted", out1), ("resumed", out2))}
        val = [r["val"] for r in _read_log(twin_dir) if "val" in r]
    step_ms = {name: float(np.median([1e3 / r["steps_per_sec"] for r in logs[name][2:]]))
               for name in ("one", "twin")}
    print(f"ddp two ranks on one card ({card_name}; {', '.join(backends)}): losses against one "
          f"process, largest relative difference by step {[f'{x:.2e}' for x in rel]}; step ms "
          f"from step 3, median: two ranks {step_ms['twin']:.1f}, one process "
          f"{step_ms['one']:.1f}; wall {twin_s:.1f} s for the twin and the preempted run side "
          f"by side, {resume_s:.1f} s for the resumed run, {one_s:.1f} s for one process "
          "(in this process)", flush=True)
    print(f"ddp SIGTERM to the launcher: both ranks stopped at step {stops[0]}; the resumed "
          f"log reads 1..{DDP_STEPS}; largest relative loss difference from the uninterrupted "
          f"twin {resumed:.3e}; K1 launches of the validation: one process {one_k1}, ranks "
          f"{k1_ranks}; " + json.dumps({k: val[0][k] for k in ("average_pts_within_thresh",
                                                                "average_jaccard")}),
          flush=True)
    split = [label for label, st in states.items() if len(st) != 2 or len(set(st.values())) != 1]
    print("ddp trained state of the two ranks (sha256 of parameters and BatchNorm buffers): "
          + "; ".join(f"{label} {'equal' if label not in split else st}"
                      for label, st in states.items())
          + f"; resumed run {'equal' if states['resumed'] == states['twin'] else 'unequal'} to "
          "the twin's", flush=True)
    if backends != ["gloo"]:
        raise AssertionError(f"ddp: backends {backends}; ranks sharing a card must use gloo")
    if not rel[0] <= DDP_LOSS_RTOL:
        raise AssertionError(f"ddp: step 1 losses {rel[0]:.2e} from one process's")
    if not max(rel[1:]) <= DDP_LATER_RTOL:
        raise AssertionError(f"ddp: steps 2..{DDP_STEPS} losses {max(rel[1:]):.2e} from one "
                             "process's")
    if split:
        raise AssertionError(f"ddp: the ranks' trained states differ in {split}")
    if not resumed <= DDP_LOSS_RTOL:
        raise AssertionError(f"ddp: the resumed run's losses {resumed:.2e} from the twin's")
    if not (one_k1 > 0 and k1_ranks.get(0, 0) > 0 and k1_ranks.get(1) == 0 and len(val) == 1):
        raise AssertionError(f"ddp: validation K1 launches one {one_k1}, ranks {k1_ranks}")
    check_metrics(val[0])
    _add_launches(record, one_k1 + sum(k1_ranks.values()))


def _maybe_log(work_dir):
    try:
        return _read_log(work_dir)
    except (OSError, ValueError):
        return []


# --------------------------------------------------------------------- #
# propmodes: the propagation modes beside the kernel (plain PyTorch)
# --------------------------------------------------------------------- #
# the cut of video 0 that propmodes runs on the card and on the CPU:
# frames, and the side of its central square
PROP_CUT_T, PROP_CUT_SIZE = 8, 128
# propmodes' video: 24 frames made as the e2e pickles are (the e2e videos'
# 48 cost the phase about 25 s more)
PROP_T = 24


@contextlib.contextmanager
def _recording(kind):
    """Tracker.track_{kind}_dispatch and _collect wrapped for the block:
    each video's output and its device ms from the dispatch (features,
    propagation, decode) to the end of the collect, by CUDA events."""
    import torch

    from fgvc_tpu_torch.models.tracker import Tracker

    names = (f"track_{kind}_dispatch", f"track_{kind}_collect")
    dispatch, collect = (getattr(Tracker, n) for n in names)
    rec = {"outs": [], "ms": []}

    def timed_dispatch(self, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        disp = dispatch(self, *args, **kw)
        disp["_start"] = start
        return disp

    def timed_collect(self, disp):
        out = collect(self, disp)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        rec["ms"].append(disp["_start"].elapsed_time(end))
        rec["outs"].append(out)
        return out

    setattr(Tracker, names[0], timed_dispatch)
    setattr(Tracker, names[1], timed_collect)
    try:
        yield rec
    finally:
        setattr(Tracker, names[0], dispatch)
        setattr(Tracker, names[1], collect)


def _video0_propagated(ds):
    s = ds[0]
    return sum(len(s["video"]) - int(t) - 1
               for t in np.unique(s["query_points"][:, 0].astype(int)))


def _prop_line(label, ms, T, frames, peak, card):
    return (f"propmodes {label}: {ms:.1f} ms per video ({T} frames, {frames} propagated; "
            f"features, propagation and decode by CUDA events), {1e3 * T / ms:.2f} frames/s, "
            f"{ms / frames:.3f} ms per propagated frame, peak device memory {peak:.2f} GB "
            f"[{card}]")


def _prop_tapvid(data_root, label, card, spatial=None, **overrides):
    """run_task('davis', max_videos=1) on video 0 in one mode: trajectories,
    metrics, device ms, peak memory, the attention kernel's launches."""
    import dataclasses

    import torch

    from fgvc_tpu_torch.apis.test import run_task
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    ds = TapVidDataset(data_root)
    cfg = dataclasses.replace(DAVIS_TEST_CFG, **overrides)
    k1.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _recording("points") as rec:
        t0 = time.time()
        metrics = run_task("davis", data_root, test_cfg=cfg, device="cuda", seed=0,
                           max_videos=1, spatial_devices=spatial)
        wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_metrics(metrics)
    frames = _video0_propagated(ds)
    print(_prop_line(label, rec["ms"][0], len(ds[0]["video"]), frames, peak, card)
          + f"; run_task wall {wall:.2f} s; <D {metrics['average_pts_within_thresh']:.4f}",
          flush=True)
    launches = {"banked": k1.launches, "unbanked": k1.unbanked_launches,
                "row_block": k1.row_block_launches}
    return {"traj": rec["outs"][0]["trajectories"], "metrics": metrics, "launches": launches,
            "frames": frames}


def _hold_tracks(label, run, ref, median_px=TRAJ_TOL_PX, delta_d=DELTA_D_TOL):
    """Trajectories median |diff| <= median_px and <D within delta_d (the
    <D gap printed only where delta_d is None)."""
    diff = np.abs(run["traj"] - ref["traj"])
    med = float(np.median(diff))
    d = [r["metrics"]["average_pts_within_thresh"] for r in (run, ref)]
    print(f"propmodes {label}: trajectories median |diff| {med:.3e} px, max {diff.max():.3e} px "
          f"({int((diff > median_px).sum())} coordinates beyond {median_px}); <D {d[0]:.4f} "
          f"vs {d[1]:.4f} (limits {median_px} px, {delta_d or 'none on <D'})", flush=True)
    if not med <= median_px:
        raise AssertionError(f"{label}: median trajectory difference {med} px > {median_px}")
    if delta_d is not None and not abs(d[0] - d[1]) <= delta_d:
        raise AssertionError(f"{label}: <D differs by {abs(d[0] - d[1])} > {delta_d}")


def _no_kernel(label, run):
    if any(run["launches"].values()):
        raise AssertionError(f"{label}: the attention kernel launched: {run['launches']}")


def check_tiled_frame():
    """One frame of 'tiled' (tile 32) against K1 (tile 16) on the same
    normalised TAP-Vid-shaped features and values (128 x 128 x 256, 6
    distinct slots, circle, top-10): each query pixel within 1e-4, rows
    beyond it all K1's near-tie rows, at most 0.1% of the rows."""
    import torch

    from fgvc_tpu_torch.ops import windowed_attention as wa
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    g = torch.Generator(device="cuda").manual_seed(7)
    feats = torch.randn((SLOTS + 1, H, W, C), device="cuda", generator=g)
    value = torch.rand((SLOTS, H, W, CV), device="cuda", generator=g)
    kw = dict(radius=RADIUS, temperature=TEMPERATURE, topk=TOPK)
    kbank = k1.pad_key_bank(feats, RADIUS, tile=TILE)
    halo, Hp, Wp, _, _ = k1.bank_geometry(H, W, RADIUS, TILE)
    kargs = dict(frame_idx=list(range(SLOTS)), key_valid=[True] * SLOTS, H=H, W=W, tile=TILE,
                 **kw)
    qpad = kbank[SLOTS, halo:halo + Hp, halo:halo + Wp].contiguous()
    ref = k1.topk_attention_banked(qpad, kbank, value, **kargs)
    tbank = wa.pad_key_bank(feats, RADIUS, 32)
    out = wa.masked_topk_attention_tiled(
        tbank[SLOTS, halo:halo + H, halo:halo + W], tbank, value, normalize=False, tile=32,
        frame_idx=list(range(SLOTS)), key_valid=[True] * SLOTS, **kw)
    check_rows("propmodes one frame 'tiled' vs K1", out, ref, KERNEL_TOL,
               lambda: k1.near_tie_rows_plain(qpad, kbank, value, **kargs))


def run_propmodes(data_root, card_name):
    """The phase `propmodes` (module docstring): (a)-(e)."""
    import dataclasses

    import torch

    from fgvc_tpu_torch.apis.test import build_tracker, eval_vos
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG, TOPK_IMPLS
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    t_phase = time.time()
    card = torch.device("cuda", torch.cuda.current_device())
    data_root = os.path.join(data_root, "propmodes")
    os.makedirs(data_root)
    make_tapvid_pickles(data_root, n_videos=1, T=PROP_T)
    check_tiled_frame()
    # (a) 'tiled' in each topk_impl against K1
    k1_run = _prop_tapvid(data_root, "'pallas' (K1)", card_name)
    if k1_run["launches"]["banked"] != k1_run["frames"]:
        raise AssertionError(f"K1 launches {k1_run['launches']}, expected {k1_run['frames']}")
    tiled = {}
    for impl in TOPK_IMPLS:
        label = f"'tiled' topk_impl '{impl}'"
        tiled[impl] = _prop_tapvid(data_root, label, card_name, attention_impl="tiled",
                                   topk_impl=impl)
        _no_kernel(label, tiled[impl])
        if impl == "approx":
            # every affinity tied at the k-th value weighs in fully (no tie
            # split), so it leaves K1 where features tie; reported only
            diff = np.abs(tiled[impl]["traj"] - k1_run["traj"])
            print(f"propmodes {label} vs K1 (not held): trajectories median |diff| "
                  f"{np.median(diff):.3e} px, max {diff.max():.3e} px; <D "
                  f"{tiled[impl]['metrics']['average_pts_within_thresh']:.4f}", flush=True)
        else:
            # 'exact' takes lax.top_k's members where distinct keys tie at
            # the k-th value, K1 splits the tie: the pan moves the texture
            # by whole pixels, so features recur exactly across key frames
            # and the two rules move <D; its median is held
            _hold_tracks(f"{label} vs K1", tiled[impl], k1_run,
                         delta_d=None if impl == "exact" else DELTA_D_TOL)
    # (b) 'dense' against 'tiled' 'exact'
    dense = _prop_tapvid(data_root, "'dense'", card_name, attention_impl="dense")
    _no_kernel("'dense'", dense)
    _hold_tracks("'dense' vs 'tiled' 'exact'", dense, tiled["exact"])
    # (c) the other modes at full width, then card against CPU on the cut
    others = {"with_first_neighbor=False": dict(with_first_neighbor=False),
              "'c2f'": dict(attention_impl="c2f"),
              "'flow_guided'": dict(attention_impl="flow_guided")}
    for label, overrides in others.items():
        _no_kernel(label, _prop_tapvid(data_root, label, card_name, **overrides))
    ds = TapVidDataset(data_root)
    s = ds[0]
    tracker = build_tracker(seed=0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    k1.reset_launches()
    t0 = time.time()
    fwd = tracker.track_points_forward(s["video"], s["query_points"])
    torch.cuda.synchronize()
    ms = 1e3 * (time.time() - t0)
    frames = _video0_propagated(ds)
    print(_prop_line("track_points_forward (host clock)", ms, len(s["video"]), frames,
                     torch.cuda.max_memory_allocated() / 1e9, card_name)
          + f"; finite {bool(np.isfinite(fwd['trajectories']).all())}", flush=True)
    _no_kernel("track_points_forward", {"launches": {"banked": k1.launches}})
    _prop_cut_card_vs_cpu(s, others)
    # (d) VOS 'tiled', banked and save_mem, against K1 and K2
    vos = SyntheticDavis(n_videos=1)
    for save_mem in (False, True):
        path = "save_mem" if save_mem else "banked"
        runs = {}
        for impl in ("pallas", "tiled"):
            cfg = dataclasses.replace(DAVIS_TEST_CFG, attention_impl=impl, save_mem=save_mem)
            tracker = build_tracker(cfg, seed=0, device="cuda")
            k1.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            with _recording("masks") as rec:
                res = eval_vos(tracker, vos)
            launched = k1.launches + k1.unbanked_launches
            if (impl == "tiled") == bool(launched):
                raise AssertionError(f"vos {impl} {path}: {launched} attention kernel launches")
            T = len(vos.videos[0])
            print(_prop_line(f"vos '{impl}' {path}", rec["ms"][0], T, T - 1,
                             torch.cuda.max_memory_allocated() / 1e9, card_name)
                  + f"; J&F-Mean {res['J&F-Mean']:.6f}", flush=True)
            runs[impl] = (res["J&F-Mean"], rec["outs"][0])
            del tracker
            torch.cuda.empty_cache()
        agree = _agreement([runs["tiled"][1]], [runs["pallas"][1]])
        djf = abs(runs["tiled"][0] - runs["pallas"][0])
        print(f"propmodes vos {path} 'tiled' vs the kernel: label maps agree on "
              f"{100 * agree:.5f}% of pixels (limit {100 * PLAIN_MASK_AGREE}%), J&F-Mean "
              f"|diff| {djf:.2e} (limit {JF_TOL})", flush=True)
        if not (agree >= PLAIN_MASK_AGREE and djf <= JF_TOL):
            raise AssertionError(f"vos {path}: 'tiled' vs the kernel {agree}, {djf}")
    # (e) spatial-parallel 'tiled', the card listed twice
    sp = _prop_tapvid(data_root, "'tiled' S = 2 row blocks", card_name, spatial=[card] * 2,
                      attention_impl="tiled")
    _no_kernel("'tiled' S = 2", sp)
    diff = float(np.abs(sp["traj"] - tiled["exact"]["traj"]).max())
    print(f"propmodes 'tiled' S = 2 vs unsharded: max |diff| {diff:.3e} px (limit "
          f"{SP_TRAJ_TOL_PX}; bit for bit: {diff == 0.0})", flush=True)
    if not diff <= SP_TRAJ_TOL_PX:
        raise AssertionError(f"'tiled' row blocks differ from the unsharded run by {diff} px")
    print(f"propmodes phase {time.time() - t_phase:.1f} s [{card_name}]", flush=True)


def _prop_cut_card_vs_cpu(s, others, forward=True, tag="propmodes"):
    """Video 0 cut to PROP_CUT_T frames and its central PROP_CUT_SIZE^2,
    with the frame-0 queries inside it: each setting of `others` (and,
    where `forward`, track_points_forward) on the card against the same
    module on the CPU, median |diff| <= 1e-3 px."""
    import dataclasses

    from fgvc_tpu_torch.apis.test import build_tracker
    from fgvc_tpu_torch.config import DAVIS_TEST_CFG

    n, o = PROP_CUT_SIZE, (s["video"].shape[1] - PROP_CUT_SIZE) // 2
    video = np.ascontiguousarray(s["video"][:PROP_CUT_T, o:o + n, o:o + n])
    q = s["query_points"]
    q = q[(q[:, 0] == 0) & (q[:, 1:] >= o + 4).all(1) & (q[:, 1:] < o + n - 4).all(1)]
    if not len(q):
        raise AssertionError("no frame-0 query inside the cut")
    q = q - np.array([0, o, o], np.float32)
    runs = dict(others, **({"track_points_forward": {}} if forward else {}))
    for label, overrides in runs.items():
        cfg = dataclasses.replace(DAVIS_TEST_CFG, input_size=(n, n), **overrides)
        out = {}
        for dev in ("cuda", "cpu"):
            tracker = build_tracker(cfg, seed=0, device=dev)
            t0 = time.time()
            fn = tracker.track_points_forward if label == "track_points_forward" \
                else tracker.track_points
            out[dev] = (fn(video, q)["trajectories"], time.time() - t0)
        diff = np.abs(out["cuda"][0] - out["cpu"][0])
        med = float(np.median(diff))
        print(f"{tag} {label}, {PROP_CUT_T}-frame {n}x{n} cut ({len(q)} points): card vs "
              f"CPU median |diff| {med:.3e} px, max {diff.max():.3e} px (limit {TRAJ_TOL_PX}); "
              f"card {out['cuda'][1]:.2f} s, CPU {out['cpu'][1]:.2f} s", flush=True)
        if not med <= TRAJ_TOL_PX:
            raise AssertionError(f"{label}: card vs CPU median {med} px > {TRAJ_TOL_PX}")


# ---------------------------------------------------------------------- #
# phases reproduce and demo
# ---------------------------------------------------------------------- #
REPRO_TOL = 1e-6            # report.json against run_task on the same inputs
DEMO_T, DEMO_ORIG, DEMO_SIZE, DEMO_GRID = 24, (480, 854), 256, 8
# the committed GIF: gif_fixture_frames() through the JAX save_video (PIL's
# writer, 24 fps), its frames as cv2 decodes them pinned in the .json
GIF_FIXTURE = os.path.join("tests", "torch_port_fixtures", "gif_256x256_24f.gif")
GIF_PINS = os.path.join("tests", "torch_port_fixtures", "gif_256x256_24f.json")


def gif_fixture_frames(seed=0, T=24, size=256, points=16, tail=8, repeat=12):
    """(T, size, size, 3) uint8 RGB frames drawn like the demo's output: a
    smooth three-sine backdrop panning 2 px a frame, and `points` tracks of
    seeded colours moving in straight lines, each a 5 x 5 square at its
    current position with a one-pixel tail of its last `tail` positions;
    frame `repeat` repeats the one before (PIL's writer merges it)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    freq = rng.uniform(0.01, 0.035, (3, 2))
    phase = rng.uniform(0, 2 * np.pi, 3)
    p0 = rng.uniform(24, size - 24, (points, 2))
    vel = rng.uniform(-3, 3, (points, 2))
    cols = rng.integers(0, 256, (points, 3), dtype=np.uint8)
    frames = []
    for t in range(T):
        if t == repeat:
            frames.append(frames[-1].copy())
            continue
        bg = 128 + 100 * np.sin(freq[:, :1, None] * (xx + 2 * t) + freq[:, 1:, None] * yy
                                + phase[:, None, None])
        f = np.ascontiguousarray(np.rint(bg).astype(np.uint8).transpose(1, 2, 0))
        for p in range(points):
            for s in range(max(0, t - tail), t + 1):
                x, y = np.clip(np.rint(p0[p] + vel[p] * s), 0, size - 1).astype(int)
                r = 2 if s == t else 0
                f[max(0, y - r):y + r + 1, max(0, x - r):x + r + 1] = cols[p]
        frames.append(f)
    return np.stack(frames)


def _exit_code(fn):
    """fn()'s SystemExit code (0 when it returns)."""
    try:
        fn()
    except SystemExit as e:
        return e.code
    return 0


def make_reference_pth(path, seed=0, broken=False):
    """Seeded ResNet-18-d1 weights under the reference's mmcv names
    ({'state_dict': ...}, prefix 'backbone.'): convolutions as init_random
    draws them, every BatchNorm's affine and running statistics from a
    seeded generator (variances in [0.5, 1.5]).  `broken` makes one
    variance of layer2 negative, which no trained network has."""
    import torch

    from fgvc_tpu_torch.models.resnet import init_random, resnet18_d1
    from fgvc_tpu_torch.models.weights import export_reference_state_dict

    model = init_random(resnet18_d1(), seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(n, generator=g))
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
        if broken:
            model.layer2[0].bn1.running_var[3] = -1.0
    torch.save({"state_dict": export_reference_state_dict(model.state_dict())}, path)
    return path


def run_reproduce(data_root, jhmdb_root, badja_root, records, card_name, device="cuda"):
    """Phase reproduce (see the module's docstring)."""
    import torch

    from fgvc_tpu_torch.apis.test import run_task
    from fgvc_tpu_torch.cli import reproduce
    from fgvc_tpu_torch.datasets.tapvid import TapVidDataset
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    t_phase = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_reproduce_") as root:
        pth = make_reference_pth(os.path.join(root, "seeded.pth"))
        t0 = time.time()
        probe = reproduce.parity_probe(pth, device=device)
        probe_s = time.time() - t0
        print(f"reproduce probe on {device} ({card_name}): layer3 max|diff| {probe['max_abs']:.3e} "
              f"(limit {reproduce.PROBE_TOL}) in {probe_s:.2f} s, 2 frames at 256 x 256",
              flush=True)
        if not probe["ok"]:
            raise AssertionError(f"reproduce: the probe failed on the card: {probe}")
        video0 = TapVidDataset(data_root)[0]
        tapvid = sum(len(video0["video"]) - int(t) - 1
                     for t in np.unique(video0["query_points"][:, 0].astype(int)))
        expect = {"davis": tapvid, "kinetics": tapvid, "jhmdb": JHMDB_T - 1,
                  "badja": BADJA_T - 1}
        roots = {"davis": data_root, "kinetics": data_root, "jhmdb": jhmdb_root,
                 "badja": badja_root}
        out = os.path.join(root, "out")
        argv = ["--checkpoint", pth, "--max-videos", "1", "--fast-modes", "--output-dir", out,
                "--device", device]
        for task, task_root in roots.items():
            argv += [f"--{task}-root", task_root]
        k1.reset_launches()
        t0 = time.time()
        code = _exit_code(lambda: reproduce.main(argv))
        wall = time.time() - t0
        # float32 circle: davis, kinetics, coarse_decode; bfloat16 circle:
        # bf16_matmuls, pallas_bf16_yuv; float32 square: jhmdb, badja
        circle = 2 * expect["davis"] + expect["kinetics"]
        bf16 = 2 * expect["davis"]
        square = expect["jhmdb"] + expect["badja"]
        got = (k1.launches, k1.unbanked_launches, k1.row_block_launches, dict(k1.mode_launches))
        want = (circle + bf16 + square, 0, 0,
                {m: {"float32": circle + square, "bfloat16": bf16}.get(m, 0)
                 for m in k1.mode_launches})
        print(f"reproduce CLI: exit {code} in {wall:.1f} s; K1 launches (banked, unbanked, row "
              f"blocks, by mode) {got}, expected {want}", flush=True)
        if code != 1:
            raise AssertionError(f"reproduce: exit {code}, expected 1 (seeded weights)")
        if device == "cuda" and got != want:
            raise AssertionError(f"reproduce: K1 launches {got}, expected {want}")
        _add_launches(records["K1_circle"], got[3]["float32"] - square)
        _add_launches(records["K3_bf16_circle"], got[3]["bfloat16"])
        _add_launches(records["K1_square_jhmdb"], expect["jhmdb"])
        _add_launches(records["K1_square_badja"], expect["badja"])
        with open(os.path.join(out, "report.json")) as f:
            report = json.load(f)
        if abs(report["feature_parity"]["max_abs"] - probe["max_abs"]) > reproduce.PROBE_TOL:
            raise AssertionError("reproduce: the CLI's probe differs from the probe's")
        for task, task_root in roots.items():
            (ref, dt) = _timed(lambda: run_task(task, task_root, checkpoint=pth, max_videos=1,
                                                device=device))
            rep = report["tasks"][task]
            diff = max([abs(rep["value"] - ref[rep["metric"]])]
                       + [abs(v - ref[k]) for k, v in rep["all_metrics"].items()])
            print(f"reproduce {task}: {rep['metric']} {rep['value']:.4f} (published "
                  f"{rep['expected']}); run_task on the same inputs in {dt:.2f} s "
                  f"({card_name}), largest |diff| of every metric {diff:.3e}", flush=True)
            if not diff <= REPRO_TOL:
                raise AssertionError(f"reproduce {task}: report.json differs from run_task")
        print("reproduce fast modes: " + json.dumps(report["fast_modes"]), flush=True)
        bad = make_reference_pth(os.path.join(root, "broken.pth"), broken=True)
        code = _exit_code(lambda: reproduce.main(["--checkpoint", bad, "--output-dir",
                                                  os.path.join(root, "bad"), "--device",
                                                  device, "--davis-root", data_root]))
        print(f"reproduce with a negative BatchNorm variance: exit {code}", flush=True)
        if code != 2 or os.path.exists(os.path.join(root, "bad", "report.json")):
            raise AssertionError(f"reproduce: a broken .pth gave exit {code}, expected 2")
    print(f"reproduce phase {time.time() - t_phase:.1f} s [{card_name}]", flush=True)


def make_demo_frames(root, T=DEMO_T, orig=DEMO_ORIG, seed=0):
    """A directory of T frames of a panning texture at `orig`, even frames
    as JPEG (encode_jpeg, quality 90) and odd ones as PNG; returns it."""
    from fgvc_tpu_torch.data_io.fgpack import encode_jpeg

    frames, _ = _panning(np.random.default_rng(seed), T, orig, 1.0)
    path = os.path.join(root, "frames")
    os.makedirs(path)
    for t, f in enumerate(frames):
        if t % 2:
            encode_png(os.path.join(path, f"f{t:03d}.png"), f)
        else:
            with open(os.path.join(path, f"f{t:03d}.jpg"), "wb") as fh:
                fh.write(encode_jpeg(f, 90))
    return path


def run_demo(records, card_name, device="cuda"):
    """Phase demo (see the module's docstring)."""
    import dataclasses

    from fgvc_tpu_torch.apis.test import TASK_CONFIGS, build_tracker
    from fgvc_tpu_torch.cli import demo
    from fgvc_tpu_torch.data_io.fgpack import encode_jpeg
    from fgvc_tpu_torch.datasets.image_io import read_image
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1
    from fgvc_tpu_torch.utils import visualize

    t_phase = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_demo_") as root:
        frames = make_demo_frames(root, DEMO_T, DEMO_ORIG)
        base = ["--frames", frames, "--size", str(DEMO_SIZE), "--device", device]
        out = os.path.join(root, "tracks.mp4")
        k1.reset_launches()
        _, wall = _timed(lambda: demo.main([*base, "--grid", str(DEMO_GRID), "--out", out]))
        if device == "cuda":
            check_launches("demo", "highest", DEMO_T - 1, "banked")
        _add_launches(records["K1_circle"], DEMO_T - 1)
        # the same steps apart, timed: read, track, draw, encode
        video, read_s = _timed(lambda: demo.load_frames(frames, DEMO_SIZE))
        cfg = dataclasses.replace(TASK_CONFIGS["davis"], input_size=(DEMO_SIZE, DEMO_SIZE))
        tracker = build_tracker(cfg, device=device)
        pts = demo.query_grid(DEMO_SIZE, DEMO_GRID)
        queries = np.concatenate([np.zeros((len(pts), 1)), pts], 1).astype(np.float32)
        tracker.track_points(video, queries)  # warm-up
        traj, track_s = _timed(lambda: tracker.track_points(video, queries)["trajectories"])
        drawn, draw_s = _timed(lambda: demo.render_tracks(video, traj))
        samples, enc_s = _timed(lambda: [encode_jpeg(f, 95, sampling="444") for f in drawn])
        mp4 = visualize.read_mp4(out)
        if len(mp4.samples) != DEMO_T or mp4.samples != samples:
            raise AssertionError("demo: the .mp4's samples differ from the rendered frames'")
        ms = {k: 1e3 * v / DEMO_T for k, v in (("read", read_s), ("track", track_s),
                                               ("draw", draw_s), ("encode", enc_s))}
        print(f"demo --grid {DEMO_GRID} ({DEMO_GRID ** 2} points, {DEMO_T} frames of "
              f"{DEMO_ORIG[0]}x{DEMO_ORIG[1]} read at {DEMO_SIZE}): {DEMO_T - 1} K1 launches, "
              f"CLI {wall:.2f} s (model build included); ms a frame ({card_name}): "
              + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
              + f"; the .mp4 {os.path.getsize(out) / 1e6:.3f} MB, {DEMO_T} Motion-JPEG "
              "samples equal to encode_jpeg of the rendered frames", flush=True)
        corr = os.path.join(root, "corr.png")
        demo.main([*base, "--correspondence", "--out", corr])
        matches = demo.correspondence_matches(tracker, video, DEMO_SIZE)
        if not np.array_equal(read_image(corr),
                              visualize.correspondence_overlay(video[0], video[1], matches)):
            raise AssertionError("demo --correspondence: the .png differs from the overlay")
        labels = np.zeros(DEMO_ORIG, np.uint8)
        labels[100:220, 150:400], labels[260:420, 450:760] = 1, 2
        mask = os.path.join(root, "mask.png")
        encode_png(mask, labels, palette=np.repeat(np.arange(3, dtype=np.uint8)[:, None], 3, 1))
        masks_out = os.path.join(root, "masks.mp4")
        k1.reset_launches()
        demo.main([*base, "--mask", mask, "--out", masks_out])
        if device == "cuda":
            check_launches("demo --mask", "highest", DEMO_T - 1, "banked")
        _add_launches(records["K1_square"], DEMO_T - 1)
        if len(visualize.read_mp4(masks_out).samples) != DEMO_T:
            raise AssertionError("demo --mask: the .mp4 lacks frames")
        # its own Motion-JPEG .mp4 read back by the port's video reader
        # (FFmpeg's decoding and 4:4:4 conversion, cv2's pixels; libjpeg's
        # decode of the same samples, read_video's, parts from it by a few
        # levels), then tracked with --video
        from fgvc_tpu_torch.data_io.video import VideoReader

        with VideoReader(masks_out) as reader:
            back = list(reader)
            codec, mjpeg_ms = reader.codec, 1e3 * sum(reader.timings.values()) / max(len(back), 1)
        libjpeg = visualize.read_video(masks_out)[0][..., ::-1]
        gap = float(np.abs(np.stack(back).astype(np.int16) - libjpeg).mean()) if back else -1.0
        if (codec != "mp4v (JPEG)" or len(back) != DEMO_T
                or back[0].shape != (DEMO_SIZE, DEMO_SIZE, 3) or not 0 <= gap < 1.0):
            raise AssertionError(f"demo: its .mp4 read back as {codec!r}, {len(back)} frames "
                                 f"of {back[0].shape if back else None}, mean gap {gap}")
        k1.reset_launches()
        video_out = os.path.join(root, "masks_tracked.mp4")
        _, video_s = _timed(lambda: demo.main(["--video", masks_out, "--size", str(DEMO_SIZE),
                                                "--grid", str(DEMO_GRID), "--out", video_out,
                                                "--device", device]))
        if device == "cuda":
            check_launches("demo --video on its own .mp4", "highest", DEMO_T - 1, "banked")
        _add_launches(records["K1_circle"], DEMO_T - 1)
        if len(visualize.read_mp4(video_out).samples) != DEMO_T:
            raise AssertionError("demo --video on its own .mp4: the output lacks frames")
        print(f"demo --correspondence: {corr} equal to the overlay of its 64 matches; --mask: "
              f"{DEMO_T - 1} K1 square launches, {os.path.getsize(masks_out) / 1e6:.3f} MB; "
              f"that .mp4 read back by VideoReader ({codec!r}, {len(back)} frames of "
              f"{DEMO_SIZE}x{DEMO_SIZE}, {mjpeg_ms:.3f} host ms a frame [{card_name}], mean "
              f"|cv2-path - libjpeg| {gap:.4f}); --video on it: {DEMO_T - 1} K1 circle "
              f"launches, {video_s:.2f} s", flush=True)
        _demo_gif(records, card_name, root, base, drawn, device)
    print(f"demo phase {time.time() - t_phase:.1f} s [{card_name}]", flush=True)


def _demo_gif(records, card_name, root, base, drawn, device):
    """The demo phase's GIF part: (a) gif_fixture_frames written by
    save_video, byte for byte the committed fixture (what PIL's writer gave
    the JAX save_video), with the quantiser's and the LZW encoder's ms a
    frame; (b) the fixture decoded to cv2's pins; (c) the demo's own
    tracks.gif, every frame read back equal to the colours of its own
    palette (`drawn`: the demo's frames rendered again from the same
    tracks), frames equal to the one before merged as PIL merges them; (d)
    demo --video on it, K1 circle once a frame propagated."""
    from fgvc_tpu_torch.cli import demo
    from fgvc_tpu_torch.data_io import gif
    from fgvc_tpu_torch.data_io.video import VideoReader
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1
    from fgvc_tpu_torch.utils import visualize

    t_part = time.time()
    with open(os.path.join(ROOT, GIF_PINS)) as f:
        pins = json.load(f)
    frames = gif_fixture_frames(pins["seed"])
    out = os.path.join(root, "fixture.gif")
    _, write_s = _timed(lambda: visualize.save_video(frames, out, pins["fps"]))
    with open(out, "rb") as f, open(os.path.join(ROOT, GIF_FIXTURE), "rb") as g:
        same, mb = f.read() == g.read(), os.path.getsize(out) / 1e6
    if not same:
        raise AssertionError(f"demo (gif): save_video's bytes differ from {GIF_FIXTURE}")
    quantised, quant_s = _timed(lambda: [gif.quantize(f) for f in frames])
    _, lzw_s = _timed(lambda: [gif.lzw_blocks(index) for _, index in quantised])
    print(f"demo (gif): {len(frames)} frames of {frames.shape[2]}x{frames.shape[1]} "
          f"(gif_fixture_frames({pins['seed']})) written by save_video in {write_s:.3f} s, byte "
          f"for byte {GIF_FIXTURE} ({mb:.3f} MB); ms a frame ({card_name}): quantise "
          f"{1e3 * quant_s / len(frames):.3f}, LZW-encode {1e3 * lzw_s / len(frames):.3f}",
          flush=True)
    _video_pins(GIF_FIXTURE, GIF_PINS, "demo (gif)", card_name)
    tracks = os.path.join(root, "tracks.gif")
    k1.reset_launches()
    _, wall = _timed(lambda: demo.main([*base, "--grid", str(DEMO_GRID), "--out", tracks]))
    if device == "cuda":
        check_launches("demo --out tracks.gif", "highest", DEMO_T - 1, "banked")
    _add_launches(records["K1_circle"], DEMO_T - 1)
    kept = []
    for palette, index in (gif.quantize(f) for f in drawn):
        colours = np.frombuffer(palette, np.uint8).reshape(-1, 3)[index]
        if not kept or not np.array_equal(colours, kept[-1]):
            kept.append(colours)
    with VideoReader(tracks) as reader:
        back, count = list(reader), reader.frame_count
        read_ms = 1e3 * sum(reader.timings.values()) / max(len(back), 1)
    if count != len(kept) or len(back) != len(kept) or not all(
            np.array_equal(a[..., ::-1], b) for a, b in zip(back, kept)):
        raise AssertionError(f"demo (gif): tracks.gif read back as {len(back)} frames (count "
                             f"{count}), not the {len(kept)} frames of its palettes' colours")
    k1.reset_launches()
    again = os.path.join(root, "tracks_again.gif")
    _, video_s = _timed(lambda: demo.main(["--video", tracks, "--size", str(DEMO_SIZE),
                                            "--grid", str(DEMO_GRID), "--out", again,
                                            "--device", device]))
    if device == "cuda":
        check_launches("demo --video tracks.gif", "highest", len(kept) - 1, "banked")
    _add_launches(records["K1_circle"], len(kept) - 1)
    print(f"demo (gif): --out tracks.gif {DEMO_T - 1} K1 circle launches, CLI {wall:.2f} s, "
          f"{os.path.getsize(tracks) / 1e6:.3f} MB, {len(back)} frames (of {DEMO_T}; "
          f"{DEMO_T - len(kept)} merged) read back equal to their palettes' colours, "
          f"{read_ms:.3f} host ms a frame [{card_name}]; --video on it: {len(kept) - 1} K1 "
          f"circle launches, {video_s:.2f} s; the GIF part {time.time() - t_part:.1f} s",
          flush=True)


# ---------------------------------------------------------------------- #
# phase video
# ---------------------------------------------------------------------- #
# (the letters of its parts: pins, --annotations, demo --video, "-" where
# the clip skips that part; clip; cv2's pins) for VP8 in WebM, for MPEG-4
# Part 2 (cv2's mp4v) in MP4, for VP9 in WebM, for MPEG-4 Part 2 (cv2's XVID)
# and Motion-JPEG (cv2's MJPG) in AVI (--annotations looks up .mp4, .mkv
# and .webm clips only, as the JAX reader does), and for the port's own
# 4:4:4 Motion-JPEG .mp4 (save_video)
VIDEO_CLIPS = tuple((tags, os.path.join("tests", "torch_port_fixtures", name + ext),
                     os.path.join("tests", "torch_port_fixtures", name + ".json"))
                    for tags, name, ext in (("abc", "vp8_640x360_250f", ".webm"),
                                            ("def", "mp4v_640x360_250f", ".mp4"),
                                            ("ghi", "vp9_640x360_250f", ".webm"),
                                            ("j-j", "mp4v_640x360_48f", ".avi"),
                                            ("k-k", "mjpg_640x360_48f", ".avi"),
                                            ("ll-", "mjpg_444_320x180_24f", ".mp4"),
                                            # odd heights: swscale's scaling path
                                            ("mm-", "vp8_256x143_24f", ".webm"),
                                            ("n--", "vp9_bt709_256x143_24f", ".webm"),
                                            ("o--", "mp4v_255x143_24f", ".mp4"),
                                            ("p--", "mjpg_422_256x143_12f", ".avi")))
# tools cv2's writers do not use, pinned to their encoder's own decoder's
# planes and to cv2's frames, by the clip they precede: MPEG-4 Part 2 from
# libavcodec (B-VOPs, 4MV, AC prediction and video packets; quarter-pel, data
# partitioning and XviD's IDCT); VP9 from libvpx (alt-ref superframes,
# compound prediction, tile columns, backward adaptation; segmentation,
# error resilience, lossless, bilinear, show_existing_frame)
VIDEO_TOOLS = {tags: tuple((os.path.join("tests", "torch_port_fixtures", name + ext),
                            os.path.join("tests", "torch_port_fixtures", name + ".json"))
                           for name in names)
               for tags, ext, names in (
                   ("def", ".mp4", ("mp4v_bvop_4mv_176x144", "mp4v_qpel_dp_xvid_96x64")),
                   ("ghi", ".mkv", ("vp9_altref_compound_tiles_512x128",
                                    "vp9_aq_errres_lossless_bilinear_96x64")))}
VIDEO_IDS, VIDEO_TRACKS = ("clip_a", "clip_b"), 32
VIDEO_DEMO_FRAMES, VIDEO_DEMO_GRID = 48, 8


def write_video_csv(path, T, seed=0, ids=VIDEO_IDS):
    """TAP-Vid-Kinetics CSV rows for `ids`: VIDEO_TRACKS points each,
    drifting slowly, visible at frame 0 (so 'first' queries start there)
    and occluded at five later frames."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        f.write("video_id,point_id,frame,x,y,occluded\n")
        for vid in ids:
            for pid in range(VIDEO_TRACKS):
                p0, vel = rng.uniform(0.1, 0.9, 2), rng.uniform(-1e-3, 1e-3, 2)
                hidden = set(rng.integers(1, T, 5).tolist())
                for t in range(T):
                    x, y = np.clip(p0 + vel * t, 0.0, 1.0)
                    f.write(f"{vid},{pid},{t},{x:.6f},{y:.6f},{int(t in hidden)}\n")


def _video_pins(fixture, pins, label, card_name, yuv=False):
    """Decode a committed clip on the host and hold it to its pins: every
    frame's sha256 (and its planes' where `yuv`), the count and the fps;
    print the host ms a frame for demux, decode and conversion."""
    import hashlib

    from fgvc_tpu_torch.data_io.video import VideoReader

    with open(os.path.join(ROOT, pins)) as f:
        pinned = json.load(f)
    planes = []
    with VideoReader(os.path.join(ROOT, fixture)) as reader:
        digests = []
        for frame in reader:
            digests.append(hashlib.sha256(frame.tobytes()).hexdigest())
            if yuv:
                planes.append(hashlib.sha256(b"".join(
                    p.tobytes() for p in reader.planes())).hexdigest())
        meta = (reader.frame_count, reader.fps)
        timings, codec, feats = dict(reader.timings), reader.codec, reader.features()
    n = len(digests)
    if digests != pinned["sha256"] or meta != (pinned["cv2_frame_count"], pinned["cv2_fps"]) \
            or (yuv and planes != pinned["yuv_sha256"]):
        bad = [i for i, (a, b) in enumerate(zip(digests, pinned["sha256"])) if a != b]
        raise AssertionError(f"{label}: {n} frames (pinned {pinned['frames']}), count and fps "
                             f"{meta}, frames differing from the pins {bad[:10]}")
    ms = {k: 1e3 * v / n for k, v in timings.items()}
    print(f"{label}: {os.path.basename(fixture)} ({codec}), {n} frames of "
          f"{pinned['width']}x{pinned['height']} equal to the sha256 pins"
          + (" (planes and frames)" if yuv else "") + f", count {meta[0]}, fps {meta[1]}; "
          f"host ms a frame ({card_name}): " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()),
          flush=True)
    return n, feats


def _video_clip(records, card_name, tags, fixture, pins):
    """One committed clip through the video path: its pins on the host,
    cli.test --task kinetics --annotations (K1 circle once a
    frame propagated, metrics equal to the pickle path's), the demo's
    --video (K1 circle once a frame after the first); a part whose letter
    in `tags` is "-" is skipped."""
    n, _ = _video_pins(fixture, pins, f"video ({tags[0]})", card_name)
    fixture = os.path.join(ROOT, fixture)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_video_") as root:
        if tags[1] != "-":
            _video_annotations(records, tags[1], fixture, root, n)
        if tags[2] != "-":
            _video_demo(records, tags[2], fixture, root, min(n, VIDEO_DEMO_FRAMES))


def _video_annotations(records, tag, fixture, root, n):
    """cli.test --task kinetics --annotations over the clip (two copies of
    a short one, one of a 250-frame one), then run_task over pickles of the
    port's decode of it: equal metrics."""
    import io
    import shutil

    import torch

    from fgvc_tpu_torch.apis.test import run_task
    from fgvc_tpu_torch.cli import test as cli_test
    from fgvc_tpu_torch.datasets.tapvid_kinetics import (assemble_tracks, read_annotations)
    from fgvc_tpu_torch.datasets.video_decode import decode_video
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1

    # a 250-frame clip runs under one id, a short one under two (the
    # script's time limit cut the long clips' second copy)
    ids = VIDEO_IDS if n <= VIDEO_DEMO_FRAMES else VIDEO_IDS[:1]
    clips = os.path.join(root, "clips")
    os.makedirs(clips)
    for vid in ids:
        shutil.copy(fixture, os.path.join(clips, vid + os.path.splitext(fixture)[1]))
    csv_path = os.path.join(root, "tapvid_kinetics.csv")
    write_video_csv(csv_path, n, ids=ids)
    expect = len(ids) * (n - 1)  # one query group a video, at frame 0
    k1.reset_launches()
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        cli_test.main(["--task", "kinetics", "--annotations", csv_path, "--data-root", clips,
                       "--output-dir", os.path.join(root, "report")])
    torch.cuda.synchronize()
    cli_s = time.time() - t0
    text = out.getvalue()
    metrics = json.loads(text[text.index("{"):text.rindex("}") + 1])
    check_launches(f"video ({tag}) --annotations", "highest", expect, "banked")
    check_metrics(metrics)
    _add_launches(records["K1_circle"], expect)
    # the pickle path on the port's own decode of the same clip and tracks
    t0 = time.time()
    video = decode_video(fixture, resize=(256, 256))
    decode_s = time.time() - t0
    per_video = read_annotations(csv_path)
    pkl_root = os.path.join(root, "pickles")
    os.makedirs(pkl_root)
    for vid in ids:
        pts, occ = assemble_tracks(per_video[vid], len(video))
        with open(os.path.join(pkl_root, f"{vid}.pkl"), "wb") as f:
            pickle.dump({"video": video, "points": pts, "occluded": occ}, f)
    t0 = time.time()
    ref = run_task("kinetics", pkl_root, device="cuda", seed=0)
    torch.cuda.synchronize()
    pkl_s = time.time() - t0
    if metrics != {k: float(v) for k, v in ref.items()}:
        raise AssertionError(f"video ({tag}): --annotations {metrics} != pickles {ref}")
    print(f"video ({tag}) metrics (random weights): " + json.dumps(
        {k: metrics[k] for k in ("average_pts_within_thresh", "average_jaccard",
                                 "occlusion_accuracy")}))
    print(f"video ({tag}): cli.test --annotations on {len(ids)} clip(s) x {n} "
          f"frames, {VIDEO_TRACKS} tracks each: {expect} K1 circle launches, {cli_s:.2f} s "
          f"(model build, decode and resize to 256 x 256 included); metrics equal to "
          f"run_task over pickles of the port's decode ({pkl_s:.2f} s; decode_video with "
          f"the resize {1e3 * decode_s / n:.2f} ms a frame)", flush=True)


def _video_demo(records, tag, fixture, root, frames):
    """The demo's --video on the clip's first `frames` frames."""
    from fgvc_tpu_torch.cli import demo
    from fgvc_tpu_torch.ops.cuda import topk_attention as k1
    from fgvc_tpu_torch.utils import visualize

    demo_out = os.path.join(root, "demo.mp4")
    k1.reset_launches()
    _, demo_s = _timed(lambda: demo.main([
        "--video", fixture, "--max-frames", str(frames), "--grid", str(VIDEO_DEMO_GRID),
        "--out", demo_out]))
    check_launches(f"video ({tag}) demo --video", "highest", frames - 1, "banked")
    _add_launches(records["K1_circle"], frames - 1)
    if len(visualize.read_mp4(demo_out).samples) != frames:
        raise AssertionError(f"video ({tag}) demo --video: the .mp4 lacks frames")
    print(f"video ({tag}): demo --video --max-frames {frames} --grid {VIDEO_DEMO_GRID}: "
          f"{frames - 1} K1 circle launches, {demo_s:.2f} s, the .mp4 "
          f"{os.path.getsize(demo_out) / 1e6:.3f} MB", flush=True)


def _video_convert_ms(card_name, width=640, reps=20):
    """Host ms to convert one BT.601 4:2:0 frame to BGR (csrc/swscale.cpp)
    at an odd height (swscale's scaling path) beside the even height above
    it (the unscaled path), on seeded planes."""
    from fgvc_tpu_torch.data_io.fgpack import _load, _u8p

    lib = _load()
    rng = np.random.default_rng(0)
    ms = {}
    for h in (359, 360):
        y = rng.integers(0, 256, (h, width), dtype=np.uint8)
        u, v = (rng.integers(0, 256, ((h + 1) // 2, width // 2), dtype=np.uint8)
                for _ in range(2))
        out = np.empty((h, width, 3), np.uint8)

        def convert():
            path = lib.fgpack_yuv_to_bgr24(_u8p(y), _u8p(u), _u8p(v), width, width // 2, h,
                                           width, 2, 0, 0, 0, _u8p(out))
            if path != (1 if h % 2 else 0):
                raise AssertionError(f"video convert {width}x{h}: path {path}")

        ms[h] = _host_ms(convert, 1, reps=reps)
    print(f"video convert: host ms a BT.601 4:2:0 frame to BGR ({card_name}): {width} x 359 "
          f"(scaling path) {ms[359]:.3f}, {width} x 360 (unscaled path) {ms[360]:.3f}",
          flush=True)


def run_video(records, card_name):
    """Phase video (see the module's docstring)."""
    t_phase = time.time()
    for tags, fixture, pins in VIDEO_CLIPS:
        t_clip = time.time()
        for tool_clip, tool_pins in VIDEO_TOOLS.get(tags, ()):
            _, feats = _video_pins(tool_clip, tool_pins, f"video ({tags[0]}) tools", card_name,
                                   yuv=True)
            print(f"video ({tags[0]}) {os.path.basename(tool_clip)} features: " + json.dumps(
                {k: v for k, v in feats.items() if v}), flush=True)
        _video_clip(records, card_name, tags, fixture, pins)
        print(f"video ({''.join(dict.fromkeys(tags.replace('-', '')))}) "
              f"{time.time() - t_clip:.1f} s [{card_name}]",
              flush=True)
    _video_convert_ms(card_name)
    print(f"video phase {time.time() - t_phase:.1f} s [{card_name}]", flush=True)


# ---------------------------------------------------------------------- #
# phase dataprep: the data-preparation tools (fgvc_tpu_torch/tools/data)
DATAPREP_VIDEOS, DATAPREP_T, DATAPREP_ORIG = 2, 6, (720, 1280)  # YouTube-VOS's frame size
DATAPREP_SIZE, DATAPREP_ITERS = 256, 30   # the s256 tree; the reference's RAFT iterations
# the sha256 of the output trees (tree_digest) and of each pickle's video,
# made by tools/data/{prepare_ytv,pack_frames,generate_tapvid_kinetics}.py
# (cv2) on the same inputs; tests/test_torch_port_dataprep.py holds them
DATAPREP_PINS = {
    "prepare_ytv": "1c2363af3ce533067ff0ce25c3d74ea9851d13da4e3c444f761eec42f61979d2",
    "pack_frames": "4c0386450e2f11e6834e6f96f013388ac59463655d8a19242e3e50b5f26e406c",
    "kinetics": {
        "kin_vp8": "86be020419935ef4950ffc29a4194f75e759f575776ff1e56ee2086cc8a79141",
        "kin_mp4v": "2a2e9dc5d4864b112636410453bfde7cb82eb037bd20e0d0576031f07b7856bd",
        "kin_vp9": "14f541dffb702ab82d8c8e30f10a249f3d99c2015980b8cfc33b65ff5b4ce747",
    },
}
# (video id, committed clip) for generate_tapvid_kinetics, and an id whose
# clip is missing (skipped)
DATAPREP_CLIPS = (("kin_vp8", "vp8_640x360_250f.webm"), ("kin_mp4v", "mp4v_640x360_250f.mp4"),
                  ("kin_vp9", "vp9_640x360_250f.webm"))
DATAPREP_MISSING = "kin_missing"


def make_ytv_tree(root, n_videos=DATAPREP_VIDEOS, T=DATAPREP_T, orig=DATAPREP_ORIG, seed=0):
    """A YouTube-VOS JPEGImages tree: n_videos directories of T frames named
    as the dataset names them (every 5th: 00000.jpg, 00005.jpg, ...), each
    frame a window of a seeded texture (codec_pin_frame, integer arithmetic
    only) moved by whole pixels from frame to frame, encoded by the port's
    encoder at quality 95: the same bytes on every machine."""
    from fgvc_tpu_torch.data_io.fgpack import encode_jpeg

    h, w = orig
    for v in range(n_videos):
        dy, dx = 1 + v, 3 - v
        tex = codec_pin_frame(h + 4 * T, w + 4 * T, seed=seed + v)
        out = os.path.join(root, f"video_{v:02d}")
        os.makedirs(out)
        for t in range(T):
            with open(os.path.join(out, f"{5 * t:05d}.jpg"), "wb") as f:
                f.write(encode_jpeg(tex[dy * t:dy * t + h, dx * t:dx * t + w], 95))


def tree_digest(root):
    """The sha256 of a directory tree: each file's path relative to `root`
    and the sha256 of its bytes, in sorted order."""
    import hashlib

    h = hashlib.sha256()
    paths = sorted(p for p in glob.glob(os.path.join(root, "**", "*"), recursive=True)
                   if os.path.isfile(p))
    for p in paths:
        with open(p, "rb") as f:
            h.update(os.path.relpath(p, root).replace(os.sep, "/").encode() + b"\0"
                     + hashlib.sha256(f.read()).digest())
    return h.hexdigest()


def write_kinetics_csv(path, T, seed=0):
    """write_video_csv's rows for DATAPREP_CLIPS' ids, then one row of a
    video whose clip is missing."""
    write_video_csv(path, T, seed=seed, ids=[vid for vid, _ in DATAPREP_CLIPS])
    with open(path, "a") as f:
        f.write(f"{DATAPREP_MISSING},0,0,0.5,0.5,0\n")


def _quiet(fn):
    """fn() with its standard output kept; (result, the output)."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn()
    return result, out.getvalue()


def _hold_pin(label, got, want):
    print(f"dataprep {label}: sha256 {got[:16]}.. ({'equal to' if got == want else 'NOT'} "
          "the JAX tool's, cv2's)", flush=True)
    if got != want:
        raise AssertionError(f"dataprep {label}: sha256 {got}, pinned {want}")


def _dataprep_host(src, s256, packs, card_name):
    """(a) and (b): prepare_ytv and pack_frames, pinned, with host ms a frame
    of each stage."""
    from fgvc_tpu_torch.data_io.fgpack import FgPack, encode_jpeg
    from fgvc_tpu_torch.datasets.image_io import read_image, resize_area
    from fgvc_tpu_torch.tools.data import pack_frames, prepare_ytv

    n = DATAPREP_VIDEOS * DATAPREP_T
    t0 = time.time()
    _quiet(lambda: prepare_ytv.main(["--root", src, "--out", s256,
                                     "--size", str(DATAPREP_SIZE)]))
    prep_s = time.time() - t0
    _hold_pin(f"(a) prepare_ytv --size {DATAPREP_SIZE}", tree_digest(s256),
              DATAPREP_PINS["prepare_ytv"])
    t0 = time.time()
    _quiet(lambda: pack_frames.main(["--root", s256, "--out", packs, "--codec", "jpeg"]))
    pack_s = time.time() - t0
    _hold_pin("(b) pack_frames --codec jpeg", tree_digest(packs), DATAPREP_PINS["pack_frames"])
    with FgPack(os.path.join(packs, "video_00.fgpack")) as pack:
        if len(pack) != DATAPREP_T or pack[0].shape != (256, 455, 3):
            raise AssertionError(f"dataprep (b): {len(pack)} records of {pack[0].shape}")
    frame0 = sorted(glob.glob(os.path.join(src, "video_00", "*.jpg")))[0]
    big = read_image(frame0)
    small = resize_area(big, (256, 455))
    ms = {"decode 720x1280": _host_ms(lambda: read_image(frame0), 1),
          "resize_area to 256x455": _host_ms(lambda: resize_area(big, (256, 455)), 1),
          "encode 256x455 q95": _host_ms(lambda: encode_jpeg(small, 95), 1)}
    print(f"dataprep (a) prepare_ytv: {n} frames of {DATAPREP_ORIG[0]}x{DATAPREP_ORIG[1]} in "
          f"{prep_s:.2f} s ({1e3 * prep_s / n:.2f} ms a frame); (b) pack_frames --codec jpeg "
          f"{pack_s:.2f} s ({1e3 * pack_s / n:.2f} ms a frame, read and encode); host ms a "
          f"frame ({card_name}, one thread): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()), flush=True)


def _dataprep_flows(root, s256, card_name):
    """(c): precompute_flow in both formats on the card, held to the CPU on
    one pair, ms a flow and peak memory."""
    import torch

    from fgvc_tpu_torch.apis.test import build_raft_tracker
    from fgvc_tpu_torch.data_io.flo import read_flo
    from fgvc_tpu_torch.datasets.image_io import read_image
    from fgvc_tpu_torch.tools.data import precompute_flow
    from fgvc_tpu_torch.utils.profiler import events_ms

    pth = make_raft_pth(os.path.join(root, "raft_seeded.pth"))
    walls, peaks = {}, {}
    for fmt in ("flo", "uint8"):
        out_dir = os.path.join(root, f"flows_{fmt}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        _, text = _quiet(lambda: precompute_flow.main([
            "--frames-root", s256, "--out", out_dir, "--checkpoint", pth,
            "--iters", str(DATAPREP_ITERS), "--format", fmt]))
        torch.cuda.synchronize()
        walls[fmt] = time.time() - t0
        peaks[fmt] = torch.cuda.max_memory_allocated() / 1e9
        pairs = DATAPREP_VIDEOS * (DATAPREP_T - 1)
        if f"done: {DATAPREP_VIDEOS} videos, {pairs} pairs" not in text:
            raise AssertionError(f"dataprep (c) {fmt}: {text!r}")
        files = sorted(glob.glob(os.path.join(out_dir, "*", "*")))
        if len(files) != 2 * pairs:
            raise AssertionError(f"dataprep (c) {fmt}: {len(files)} files for {pairs} pairs")
        for path in files:
            a = read_flo(path) if fmt == "flo" else read_image(path)
            if a.shape != ((256, 455, 2) if fmt == "flo" else (256, 455, 3)) \
                    or not np.isfinite(a).all():
                raise AssertionError(f"dataprep (c): {path} {a.shape}")
    # one pair, card against the CPU, and the tool's function timed on video 0
    names = sorted(glob.glob(os.path.join(s256, "video_00", "*.jpg")))
    video = precompute_flow.pad_to_8(np.stack([read_image(p) for p in names]))
    base = os.path.splitext(os.path.basename(names[0]))[0]
    card = [read_flo(os.path.join(root, "flows_flo", "video_00", f"{m}_{base}.flo"))
            for m in ("forward", "backward")]
    t0 = time.time()
    cpu = build_raft_tracker(pth, iters=DATAPREP_ITERS, device="cpu").flows(video[:2])
    cpu_s = time.time() - t0
    diff = np.abs(np.stack(card) - np.stack(
        [f[0, :, :256, :455].permute(1, 2, 0).numpy() for f in cpu]))
    med, mx = float(np.median(diff)), float(diff.max())
    tracker = build_raft_tracker(pth, iters=DATAPREP_ITERS, device="cuda")
    tracker.flows(video)
    n_flows = 2 * (len(names) - 1)
    flows_ms = events_ms(lambda: tracker.flows(video), 3)
    print(f"dataprep (c) precompute_flow --iters {DATAPREP_ITERS} on the card: flo "
          f"{walls['flo']:.2f} s, uint8 {walls['uint8']:.2f} s for {DATAPREP_VIDEOS} videos x "
          f"{DATAPREP_T - 1} pairs (model build and file I/O included); peak device memory "
          f"{peaks['flo']:.3f} GB, {peaks['uint8']:.3f} GB; every flow (256, 455, 2) finite; "
          f"video_00's {n_flows} flows at {video.shape[1]}x{video.shape[2]}: "
          f"{flows_ms:.1f} ms = {flows_ms / n_flows:.3f} ms a flow (CUDA events) "
          f"[{card_name}]", flush=True)
    print(f"dataprep (c) pair {base} forward and backward, card vs CPU ({cpu_s:.1f} s on the "
          f"CPU): median |diff| {med:.3e} px, max {mx:.3e} px (limits {RAFT_FLOW_MEDIAN_PX}, "
          f"{RAFT_FLOW_MAX_PX}); |flow| up to {float(np.abs(np.stack(card)).max()):.2f} px",
          flush=True)
    if not (med <= RAFT_FLOW_MEDIAN_PX and mx <= RAFT_FLOW_MAX_PX):
        raise AssertionError(f"dataprep (c): card vs CPU flow median {med}, max {mx} px")


def _dataprep_kinetics(root, card_name):
    """(d): generate_tapvid_kinetics over the committed clips."""
    import hashlib
    import shutil

    from fgvc_tpu_torch.datasets.tapvid_kinetics import assemble_tracks, read_annotations
    from fgvc_tpu_torch.datasets.video_decode import decode_video
    from fgvc_tpu_torch.tools.data import generate_tapvid_kinetics

    clips, out_dir = os.path.join(root, "clips"), os.path.join(root, "pickles")
    os.makedirs(clips)
    for vid, name in DATAPREP_CLIPS:
        shutil.copy(os.path.join(ROOT, FIXTURE_DIR, name),
                    os.path.join(clips, vid + os.path.splitext(name)[1]))
    csv_path = os.path.join(root, "tapvid_kinetics.csv")
    write_kinetics_csv(csv_path, 250)
    t0 = time.time()
    rc, text = _quiet(lambda: generate_tapvid_kinetics.main([
        "--csv", csv_path, "--video-root", clips, "--out", out_dir]))
    tool_s = time.time() - t0
    if rc != 0 or f"wrote {len(DATAPREP_CLIPS)} video pickles" not in text:
        raise AssertionError(f"dataprep (d): exit {rc}, {text!r}")
    per_video = read_annotations(csv_path)
    for vid, name in DATAPREP_CLIPS:
        with open(os.path.join(out_dir, f"{vid}.pkl"), "rb") as f:
            got = pickle.load(f)
        video = decode_video(os.path.join(ROOT, FIXTURE_DIR, name), resize=(256, 256))
        pts, occ = assemble_tracks(per_video[vid], len(video))
        digest = hashlib.sha256(got["video"].tobytes()).hexdigest()
        if not (np.array_equal(got["video"], video) and np.array_equal(got["points"], pts)
                and np.array_equal(got["occluded"], occ)):
            raise AssertionError(f"dataprep (d) {vid}: the pickle differs from decode_video's")
        _hold_pin(f"(d) {vid} video {got['video'].shape}", digest,
                  DATAPREP_PINS["kinetics"][vid])
    print(f"dataprep (d) generate_tapvid_kinetics: {len(DATAPREP_CLIPS)} clips x 250 frames "
          f"(VP8, mp4v, VP9) and one missing in {tool_s:.2f} s "
          f"({1e3 * tool_s / (250 * len(DATAPREP_CLIPS)):.2f} ms a frame, decode and resize "
          f"to 256 x 256) [{card_name}]", flush=True)


def run_dataprep(card_name):
    """Phase dataprep (see the module's docstring)."""
    t_phase = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dataprep_") as root:
        src, s256 = os.path.join(root, "JPEGImages"), os.path.join(root, "JPEGImages_s256")
        t0 = time.time()
        make_ytv_tree(src)
        print(f"dataprep: YouTube-VOS tree of {DATAPREP_VIDEOS} x {DATAPREP_T} frames written "
              f"in {time.time() - t0:.2f} s", flush=True)
        _dataprep_host(src, s256, os.path.join(root, "packs"), card_name)
        _dataprep_flows(root, s256, card_name)
        _dataprep_kinetics(root, card_name)
    print(f"dataprep phase {time.time() - t_phase:.1f} s [{card_name}]", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="card,build,kernel,e2e,plain,raft,decode,vos,vos_plain,"
                                        "codecs,modes,zoo,kinetics,jhmdb,badja,sp,passes,overlap,"
                                        "profile,serve,export,doctor,train,realtrain,"
                                        "propmodes,dp,bank,mp,ddp,reproduce,demo,video,"
                                        "dataprep",
                    help="comma-separated phases (the module's docstring says what each "
                         "does); all of them by default")
    args = ap.parse_args()
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import fgvc_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the fgvc_tpu_torch package is not beside this file ({e})",
              file=sys.stderr)
        return 1

    pallas = "fgvc_tpu/ops/pallas/topk_attention.py"
    records = {
        # _call_fused_kernel, through fused_topk_attention_banked (K1) and
        # fused_topk_attention (K2), in 'float32' mode
        "K1_circle": kernel_record("K1 topk_attention_banked, circle", f"{pallas}:597"),
        "K1_square": kernel_record("K1 topk_attention_banked, square", f"{pallas}:597"),
        "K2": kernel_record("K2 topk_attention (unbanked), square", f"{pallas}:424"),
        # the same entry at the keypoint tasks' shapes
        "K1_square_jhmdb": kernel_record(
            f"K1 topk_attention_banked, square, JHMDB {JHMDB_H}x{JHMDB_W} Cv {JHMDB_CV}",
            f"{pallas}:597"),
        "K1_square_badja": kernel_record(
            f"K1 topk_attention_banked, square, BADJA {BADJA_H}x{BADJA_W} Cv {BADJA_CV}",
            f"{pallas}:597"),
    }
    # the same entry at the zoo's widths and grids
    for key, (entry, h, w, c, cv, shape) in ZOO_SHAPES.items():
        records[key] = kernel_record(
            f"K1 topk_attention_banked, {shape}, {entry} {h}x{w}x{c} Cv {cv}", f"{pallas}:597")
    # K3: the same kernel in mode 'high' (bf16x3, from :192) and 'bfloat16'
    # (from :201), through both entries
    for mode, tag, line in (("high", "high", 192), ("bfloat16", "bf16", 201)):
        for entry, name in (("circle", "topk_attention_banked, circle"),
                            ("square", "topk_attention_banked, square"),
                            ("unbanked", "topk_attention (unbanked), square")):
            records[f"K3_{tag}_{entry}"] = kernel_record(f"K3 '{mode}' {name}",
                                                         f"{pallas}:{line}")
    # K4: the same kernel's row-block mode (row0, from :110; grid_rows)
    for shape in ("circle", "square"):
        records[f"K4_{shape}"] = kernel_record(
            f"K4 topk_attention_banked row blocks, {shape}", f"{pallas}:110")
    # K5: the unbanked entry's profiling cut-downs ('a' from :229, 'ab' from
    # :324), in each mode
    for mode, tag in _TAG.items():
        for cut, line in (("a", 229), ("ab", 324)):
            records[f"K5_{cut}_{tag}"] = kernel_record(
                f"K5 topk_attention debug_passes='{cut}', '{mode}'", f"{pallas}:{line}")
    # the deployment entry points: K1 square behind /v1/vos at the serving
    # size, and K2 with the circle window inside the exported step
    records["K1_square_serve"] = kernel_record(
        f"K1 topk_attention_banked, square, /v1/vos {H}x{W} Cv {SERVE_CV}", f"{pallas}:597")
    records["K2_circle_export"] = kernel_record(
        f"K2 topk_attention (unbanked), circle, exported step {H}x{W} Cv {EXPORT_CV}",
        f"{pallas}:424")
    # K6: the overlap microbenchmark (make :31 -> pallas_call :92)
    for kind in ("mxu", "vpu", "mixed"):
        records[f"K6_{kind}"] = kernel_record(
            f"K6 mxu_vpu_overlap '{kind}'", "tools/bench/mxu_vpu_overlap.py:31",
            source="fgvc_tpu_torch/csrc/mxu_vpu_overlap.cu", affinity=False)
    t_start = time.time()
    phase("card")
    card_name = card_info()
    print(card_name, flush=True)  # name, power limit
    if "build" in phases:
        phase("build")
        build_kernels()
    if "kernel" in phases:
        phase("kernel")
        check_kernels(records)
        check_heatmap_kernels(records)
        check_zoo_kernels(records)
        check_tie_heavy()
        check_row_blocks(records)
    e2e_metrics = None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as data_root:
        if {"e2e", "plain", "raft", "decode", "modes", "sp", "profile", "zoo",
                "serve", "propmodes", "dp", "bank", "mp", "codecs", "reproduce"} & set(phases):
            make_tapvid_pickles(data_root)
        if "e2e" in phases:
            phase("e2e")
            e2e_metrics = run_e2e(data_root, records["K1_circle"])
        if "plain" in phases:
            phase("plain")
            run_plain_comparison(data_root)
        for name, run in (("raft", run_raft), ("decode", run_decode)):
            if name in phases:
                phase(name)
                t_phase = time.time()
                run(data_root)
                print(f"{name} phase {time.time() - t_phase:.1f} s", flush=True)
        if "vos" in phases or "vos_plain" in phases:
            ds = SyntheticDavis()
            if "vos" in phases:
                phase("vos")
                run_vos(ds, records)
            if "vos_plain" in phases:
                phase("vos_plain")
                run_vos_plain(ds)
            del ds
        if "codecs" in phases:
            phase("codecs")
            run_codecs(data_root, records, card_name)
        if "modes" in phases:
            phase("modes")
            run_modes_tapvid(data_root, records)
            run_modes_vos(records)
        jhmdb_root = os.path.join(data_root, "jhmdb")
        if {"jhmdb", "sp", "reproduce", "zoo"} & set(phases):
            os.makedirs(jhmdb_root)
            make_jhmdb_tree(jhmdb_root)
        if "zoo" in phases:
            phase("zoo")
            t_zoo = time.time()
            run_zoo(data_root, jhmdb_root, records)
            print(f"zoo phase {time.time() - t_zoo:.1f} s", flush=True)
        if "kinetics" in phases:
            phase("kinetics")
            with tempfile.TemporaryDirectory(prefix="chip_smoke_kinetics_") as kin_root:
                make_kinetics_pickle(kin_root)
                run_kinetics(kin_root, records["K1_circle"])
        badja_root = os.path.join(data_root, "badja")

        def badja_tree():
            """The BADJA tree, written at its first use."""
            if not os.path.isdir(badja_root):
                t_write = time.time()
                make_badja_tree(badja_root)
                print(f"badja tree written in {time.time() - t_write:.2f} s", flush=True)
            return badja_root

        if "jhmdb" in phases:
            phase("jhmdb")
            run_keypoints("jhmdb", jhmdb_root, records["K1_square_jhmdb"],
                          [JHMDB_T] * JHMDB_VIDEOS, JHMDB_ORIG)
        if "badja" in phases:
            phase("badja")
            run_keypoints("badja", badja_tree(), records["K1_square_badja"],
                          [BADJA_T], (320, 512))
        if "sp" in phases:
            phase("sp")
            card = torch.device("cuda", torch.cuda.current_device())
            run_sp_tapvid(data_root, records["K4_circle"], card, e2e_metrics)
            run_sp_vos(records["K4_square"], card)
            run_sp_jhmdb(jhmdb_root, records["K4_square"], card)
        if "passes" in phases:
            phase("passes")
            run_passes(records)
        if "overlap" in phases:
            phase("overlap")
            run_overlap(records)
        if "profile" in phases:
            phase("profile")
            run_profile(data_root)
        if "serve" in phases:
            phase("serve")
            run_serve(data_root, records)
        if "propmodes" in phases:
            phase("propmodes")
            run_propmodes(data_root, card_name)
        card = torch.device("cuda", torch.cuda.current_device())
        for name, run in (("dp", lambda: run_dp(data_root, records, card)),
                          ("bank", lambda: run_bank(data_root, card)),
                          ("mp", lambda: run_mp(data_root, records["K1_circle"]))):
            if name in phases:
                phase(name)
                t_phase = time.time()
                run()
                print(f"{name} phase {time.time() - t_phase:.1f} s [{card_name}]", flush=True)
        if "reproduce" in phases:
            phase("reproduce")
            run_reproduce(data_root, jhmdb_root, badja_tree(), records, card_name)
    if "demo" in phases:
        phase("demo")
        run_demo(records, card_name)
    if "video" in phases:
        phase("video")
        run_video(records, card_name)
    if "dataprep" in phases:
        phase("dataprep")
        run_dataprep(card_name)
    if "export" in phases:
        phase("export")
        run_export(records)
    if "doctor" in phases:
        phase("doctor")
        t_doctor = time.time()
        run_doctor()
        print(f"doctor phase {time.time() - t_doctor:.1f} s", flush=True)
    synth_step_ms = None
    if "train" in phases:
        phase("train")
        synth_step_ms = run_train()
    if "realtrain" in phases:
        phase("realtrain")
        run_realtrain(records["K1_circle"], synth_step_ms, card_name)
    if "ddp" in phases:
        phase("ddp")
        t_phase = time.time()
        run_ddp(records["K1_circle"], card_name)
        print(f"ddp phase {time.time() - t_phase:.1f} s [{card_name}]", flush=True)
    phase(None)
    print("seconds by phase: " + json.dumps(_PHASE["seconds"]))
    print(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
