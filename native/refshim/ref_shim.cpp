// C ABI around the reference implementation's SDR++-free coding stack.
//
// This file is part of the *interop test harness*, not the framework: it
// compiles the reference decoder/encoder components at /root/reference
// (LDPC, BCH, scramblers, deinterleavers, CC/RS codecs, TS deframer,
// BBFrame TS/GSE parser) into one shared library so this framework's
// own spec/ops implementations can be cross-validated bit-for-bit against
// the real thing, and so the reference's throughput can be measured
// headless as the performance baseline (BASELINE.md).
//
// Reference entry points wrapped here:
//   bbframe_ldpc.cpp:123-157   LDPC decode (lane-0 quirk) + encode
//   layered_decoder.hh:121-133 batched decode (all SIMD lanes filled)
//   bbframe_bch.cpp:380-456    BCH decode/encode
//   bbframe_descramble.cpp     BB derandomizer
//   s2_scrambling.cpp:37-58    PL scrambler sequence
//   s2_deinterleaver.cpp       bit (de)interleaver
//   s2_defs.h                  SOF/PLS codewords
//   modcod_to_cfg.cpp          MODCOD table
//   cc_encoder.cpp / cc_decoder.cpp  K=7 convolutional codec
//   viterbi_all.cpp            auto-rate Viterbi with lock search
//   dvbs_reedsolomon.h + common/correct  RS(204,188)
//   dvbs_interleaving.h        Forney deinterleaver
//   dvbs_scrambling.h          DVB-S energy-dispersal descrambler
//   dvbs_ts_deframer.cpp       TS super-frame deframer
//   bbframe_ts_parser.cpp      BBFrame TS/GSE->GRE parser

#include <chrono>
#include <cstdint>
#include <cstring>
#include <vector>

#include "dvbs2/dvbs2.h"
#include "common/dsp/demod/constellation.h"
#include "dvbs2/codings/bbframe_ldpc.h"
#include "dvbs2/codings/bbframe_bch.h"
#include "dvbs2/codings/bbframe_descramble.h"
#include "dvbs2/codings/s2_scrambling.h"
#include "dvbs2/codings/s2_deinterleaver.h"
#include "dvbs2/codings/modcod_to_cfg.h"
#include "dvbs2/s2_defs.h"
#include "dvbs/viterbi_all.h"
#include "dvbs/dvbs_ts_deframer.h"
#include "dvbs/dvbs_interleaving.h"
#include "dvbs/dvbs_reedsolomon.h"
#include "dvbs/dvbs_scrambling.h"
// last: defines a TS_SIZE macro that collides with the deframer's member
#include "dvbs2/bbframe_ts_parser.h"

using namespace dsp::dvbs2;
using viterbi::CCDecoder;
using viterbi::CCEncoder;
using viterbi::Viterbi_DVBS;

static dvbs2_framesize_t fsz(int shortf) {
    return shortf ? FECFRAME_SHORT : FECFRAME_NORMAL;
}

extern "C" {

// ---------------------------------------------------------------- LDPC
int ref_ldpc_simd_width() { return sizeof(simd_type) / sizeof(code_type); }

int ref_ldpc_sizes(int shortf, int rate, int *n, int *k) {
    BBFrameLDPC l(fsz(shortf), (dvbs2_code_rate_t)rate);
    *n = l.get_instance()->code_len();
    *k = l.get_instance()->data_len();
    return 0;
}

// frame: packed bytes, data_len/8 in, code_len/8 out (parity appended)
void ref_ldpc_encode(int shortf, int rate, uint8_t *frame) {
    BBFrameLDPC l(fsz(shortf), (dvbs2_code_rate_t)rate);
    l.encode(frame);
}

// As shipped by the plugin: decodes SIMD lane 0 only. llr: int8[code_len].
int ref_ldpc_decode(int shortf, int rate, int8_t *llr, int max_trials) {
    BBFrameLDPC l(fsz(shortf), (dvbs2_code_rate_t)rate);
    return l.decode(llr, max_trials);
}

// All-lane batched decode: llrs is [W][code_len] row-major (W = simd width).
// Returns trials used (max_trials - remaining), or a negative value if the
// syndrome never cleared across all lanes.
int ref_ldpc_decode_batch(int shortf, int rate, int8_t *llrs,
                          int max_trials) {
    BBFrameLDPC l(fsz(shortf), (dvbs2_code_rate_t)rate);
    LDPCInterface *ldpc = l.get_instance();
    const int N = ldpc->code_len(), K = ldpc->data_len();
    const int W = ref_ldpc_simd_width();
    LDPCDecoder<simd_type, algorithm_type> dec;
    dec.init(ldpc);
    std::vector<simd_type> buf(N);
    for (int i = 0; i < N; ++i)
        for (int w = 0; w < W; ++w)
            reinterpret_cast<code_type *>(&buf[i])[w] = llrs[w * N + i];
    // blocks=W: the syndrome gate checks every lane (alg.bad inspects the
    // first `blocks` lanes only — the plugin's blocks=1 call is why it
    // corrects just 1 of 16 frames, bbframe_ldpc.cpp:131)
    int trials = dec(buf.data(), buf.data() + K, max_trials, W);
    for (int i = 0; i < N; ++i)
        for (int w = 0; w < W; ++w)
            llrs[w * N + i] = reinterpret_cast<code_type *>(&buf[i])[w];
    if (trials < 0)
        return trials;
    return max_trials - trials;
}

// ----------------------------------------------------------------- BCH
int ref_bch_sizes(int shortf, int rate, int *kbch, int *nbch) {
    BBFrameBCH b(fsz(shortf), (dvbs2_code_rate_t)rate);
    *kbch = b.dataSize();
    BBFrameLDPC l(fsz(shortf), (dvbs2_code_rate_t)rate);
    *nbch = l.get_instance()->data_len();
    return 0;
}

int ref_bch_encode(int shortf, int rate, uint8_t *frame) {
    BBFrameBCH b(fsz(shortf), (dvbs2_code_rate_t)rate);
    return b.encode(frame);
}

int ref_bch_decode(int shortf, int rate, uint8_t *frame) {
    BBFrameBCH b(fsz(shortf), (dvbs2_code_rate_t)rate);
    return b.decode(frame);
}

// ---------------------------------------------------- BB descrambler
void ref_bb_descramble(int shortf, int rate, uint8_t *frame) {
    BBFrameDescrambler d(fsz(shortf), (dvbs2_code_rate_t)rate);
    d.work(frame);
}

// ------------------------------------------------------- PL scrambler
// Recover the Gold-sequence rotation indices R_n by probing descramble()
// with the unit sample (r: 0 -> (1,0), 1 -> (0,-1), 2 -> (-1,0), 3 -> (0,1)).
void ref_pl_scrambler_rn(uint8_t *out, int n) {
    S2Scrambling s;
    s.reset();
    for (int i = 0; i < n; ++i) {
        dsp::complex_t p{1.0f, 0.0f};
        dsp::complex_t r = s.descramble(p);
        uint8_t v = 0;
        if (r.re > 0.5f) v = 0;
        else if (r.im < -0.5f) v = 1;
        else if (r.re < -0.5f) v = 2;
        else v = 3;
        out[i] = v;
    }
}

// --------------------------------------------------- S2 deinterleaver
void ref_s2_deinterleave(int constel, int shortf, int rate,
                         int8_t *in, int8_t *out) {
    S2Deinterleaver d((dvbs2_constellation_t)constel, fsz(shortf),
                      (dvbs2_code_rate_t)rate);
    d.deinterleave(in, out);
}

void ref_s2_interleave(int constel, int shortf, int rate,
                       uint8_t *in, uint8_t *out) {
    S2Deinterleaver d((dvbs2_constellation_t)constel, fsz(shortf),
                      (dvbs2_code_rate_t)rate);
    d.interleave(in, out);
}

// ------------------------------------------------------ SOF/PLS defs
void ref_pls_codewords(uint64_t *out128) {
    s2_plscodes pls;
    memcpy(out128, pls.codewords, sizeof(pls.codewords));
}

void ref_sof_symbols(float *out52) {  // interleaved re/im, 26 symbols
    s2_sof sof;
    for (int i = 0; i < 26; ++i) {
        out52[2 * i] = sof.symbols[i].re;
        out52[2 * i + 1] = sof.symbols[i].im;
    }
}

// ------------------------------------------------------- MODCOD table
int ref_modcod_cfg(int modcod, int shortframes, int pilots,
                   int *slots, int *constel, int *rate, int *framesize,
                   float *g1, float *g2) {
    dvb_cgf_holder h = get_dvbs2_cfg(modcod, shortframes, pilots);
    *slots = h.frame_slot_count;
    *constel = (int)h.constellation;
    *rate = (int)h.coderate;
    *framesize = (int)h.framesize;
    *g1 = h.g1;
    *g2 = h.g2;
    return 0;
}

// --------------------------------------------------------- CC codec
// bits in/out are one byte per bit (0/1); soft symbols are offset-128
// unsigned (as produced by signed_soft_to_unsigned).
void ref_cc_encode(uint8_t *bits_in, int nbits, uint8_t *bits_out) {
    CCEncoder enc(nbits, 7, 2, {79, 109});
    enc.work(bits_in, bits_out);
}

void ref_cc_decode(uint8_t *soft_in, int nbits, uint8_t *bits_out) {
    CCDecoder dec(nbits, 7, 2, {79, 109});
    dec.work(soft_in, bits_out);
}

// ------------------------------------------- auto-rate Viterbi_DVBS
void *ref_viterbi_create(float ber_thresh, int max_outsync, int buf_size) {
    return new Viterbi_DVBS(ber_thresh, max_outsync, buf_size,
                            {PHASE_0, PHASE_90});
}
void ref_viterbi_destroy(void *h) { delete (Viterbi_DVBS *)h; }
int ref_viterbi_work(void *h, int8_t *soft, int size, uint8_t *out) {
    return ((Viterbi_DVBS *)h)->work(soft, size, out);
}
int ref_viterbi_state(void *h) { return ((Viterbi_DVBS *)h)->getState(); }
float ref_viterbi_ber(void *h) { return ((Viterbi_DVBS *)h)->ber(); }
int ref_viterbi_rate(void *h) { return (int)((Viterbi_DVBS *)h)->rate(); }

// ------------------------------------------------------ RS(204,188)
int ref_rs_decode(uint8_t *data204) {
    static dsp::dvbs::DVBSReedSolomon rs;
    return rs.decode(data204);
}

// RS(204,188) ENCODE through libcorrect with the exact parameters the
// reference's decoder uses (dvbs_reedsolomon.h:17: poly 8_4_3_2_0,
// fcr 0, root gap 1, 16 roots; shortened by 51 leading zeros) — lets
// interop tests build DVB-S captures whose RS parity came from the
// reference's own codec.
int ref_rs_encode(const uint8_t *data188, uint8_t *out204) {
    static correct_reed_solomon *rs = correct_reed_solomon_create(
        correct_rs_primitive_polynomial_8_4_3_2_0, 0, 1, 16);
    uint8_t buf[239];
    uint8_t enc[255];
    memset(buf, 0, 51);
    memcpy(buf + 51, data188, 188);
    ssize_t n = correct_reed_solomon_encode(rs, buf, 239, enc);
    if (n != 255) return -1;
    memcpy(out204, enc + 51, 204);
    return 0;
}

// ------------------------------------------- Forney deinterleaver
void *ref_forney_create() { return new dsp::dvbs::DVBSInterleaving(); }
void ref_forney_destroy(void *h) { delete (dsp::dvbs::DVBSInterleaving *)h; }
void ref_forney_deinterleave(void *h, uint8_t *in1632, uint8_t *out1632) {
    ((dsp::dvbs::DVBSInterleaving *)h)->deinterleave(in1632, out1632);
}
void ref_forney_interleave(void *h, uint8_t *in12, uint8_t *out12) {
    ((dsp::dvbs::DVBSInterleaving *)h)->interleave(in12, out12);
}

// ------------------------------------- DVB-S energy-dispersal PRBS
void *ref_dvbs_scrambler_create() { return new dsp::dvbs::DVBSScrambling(); }
void ref_dvbs_scrambler_destroy(void *h) {
    delete (dsp::dvbs::DVBSScrambling *)h;
}
void ref_dvbs_descramble(void *h, uint8_t *frame1632) {
    ((dsp::dvbs::DVBSScrambling *)h)->descramble(frame1632);
}

// ------------------------------------------------- TS deframer
void *ref_deframer_create() { return new deframing::DVBS_TS_Deframer(); }
void ref_deframer_destroy(void *h) {
    delete (deframing::DVBS_TS_Deframer *)h;
}
int ref_deframer_work(void *h, uint8_t *bits, int size, uint8_t *out) {
    return ((deframing::DVBS_TS_Deframer *)h)->work(bits, size, out);
}
int ref_deframer_state(void *h) {
    return ((deframing::DVBS_TS_Deframer *)h)->getState();
}

// --------------------------------------------- BBFrame TS parser
void *ref_tsparser_create(int kbch) {
    BBFrameTSParser *p = new BBFrameTSParser();
    p->setFrameSize(kbch);
    return p;
}
void ref_tsparser_destroy(void *h) { delete (BBFrameTSParser *)h; }
int ref_tsparser_work(void *h, uint8_t *bbframes, int cnt, uint8_t *out,
                      int outsize) {
    return ((BBFrameTSParser *)h)->work(bbframes, cnt, out, outsize);
}
void ref_tsparser_header(void *h, int *fields) {
    BBFrameTSParser *p = (BBFrameTSParser *)h;
    fields[0] = p->last_header.ts_gs;
    fields[1] = p->last_header.sis_mis;
    fields[2] = p->last_header.ccm_acm;
    fields[3] = p->last_header.issyi;
    fields[4] = p->last_header.npd;
    fields[5] = p->last_header.ro;
    fields[6] = p->last_header.isi;
    fields[7] = p->last_header.upl;
    fields[8] = p->last_header.dfl;
    fields[9] = p->last_header.sync;
    fields[10] = p->last_header.syncd;
    fields[11] = p->last_bb_cnt;
    fields[12] = p->last_bb_proc;
    fields[13] = p->last_ts_errs;
}

// --------------------------------------------- soft demapper
// constellation_t::demod_soft_calc (constellation.cpp:205-270): exact
// per-bit LLRs with the internal const_amp/const_prescale scale chain,
// const_sca=50, and the clamp-by-halving int8 conversion. type follows
// constellation_type_t (0 BPSK, 1 QPSK, 2 OQPSK, 3 PSK8, 4 APSK16,
// 5 APSK32); g1/g2 are the gamma radii for the APSK types.
void *ref_constellation_create(int type, float g1, float g2) {
    return new dsp::constellation_t((dsp::constellation_type_t)type, g1, g2);
}
void ref_constellation_destroy(void *h) {
    delete (dsp::constellation_t *)h;
}
int ref_constellation_bits(void *h) {
    return ((dsp::constellation_t *)h)->getBitsCnt();
}
// iq: interleaved re/im floats, n symbols -> out: n*bits int8 LLRs
// (negative = bit 1, the reference's convention)
void ref_constellation_demod_soft(void *h, const float *iq, int n,
                                  float npwr, int8_t *out) {
    dsp::constellation_t *c = (dsp::constellation_t *)h;
    int m = c->getBitsCnt();
    for (int i = 0; i < n; ++i) {
        dsp::complex_t s{iq[2 * i], iq[2 * i + 1]};
        c->demod_soft_calc(s, out + (long)i * m, nullptr, npwr);
    }
}

// ------------------------------------------------ benchmark handles
// Persistent decoder instances with the timing loop in C++, so that
// per-call construction (link-table build) and ctypes overhead do not
// penalize the reference when measuring BASELINE.md numbers.

struct LdpcBench {
    BBFrameLDPC *wrap;
    LDPCDecoder<simd_type, algorithm_type> dec;
    std::vector<simd_type> buf;
    int N, K, W;
};

void *ref_ldpc_bench_create(int shortf, int rate) {
    LdpcBench *h = new LdpcBench;
    h->wrap = new BBFrameLDPC(fsz(shortf), (dvbs2_code_rate_t)rate);
    LDPCInterface *l = h->wrap->get_instance();
    h->N = l->code_len();
    h->K = l->data_len();
    h->W = (int)(sizeof(simd_type) / sizeof(code_type));
    h->dec.init(l);
    h->buf.resize(h->N);
    return h;
}

void ref_ldpc_bench_destroy(void *p) {
    LdpcBench *h = (LdpcBench *)p;
    delete h->wrap;
    delete h;
}

// Decode the same [W][N] int8 LLR batch `reps` times with `blocks` lanes
// gated by the syndrome check (blocks=1 reproduces the shipped plugin,
// bbframe_ldpc.cpp:131; blocks=W is the fair all-lanes best case).
// Lane pack/unpack is included, as in BBFrameLDPC::decode. Returns the
// summed trials-used (negative contributions clamped to max_trials) and
// writes wall seconds to *elapsed_s.
long ref_ldpc_bench_run(void *p, int8_t *llrs, int max_trials, int blocks,
                        int reps, double *elapsed_s) {
    LdpcBench *h = (LdpcBench *)p;
    long total = 0;
    auto t0 = std::chrono::steady_clock::now();
    for (int r = 0; r < reps; ++r) {
        for (int i = 0; i < h->N; ++i)
            for (int w = 0; w < h->W; ++w)
                reinterpret_cast<code_type *>(&h->buf[i])[w] =
                    llrs[w * h->N + i];
        int trials = h->dec(h->buf.data(), h->buf.data() + h->K,
                            max_trials, blocks);
        total += (trials < 0) ? max_trials : (max_trials - trials);
        volatile int8_t sink = 0;
        for (int i = 0; i < h->N; ++i)
            sink ^= reinterpret_cast<code_type *>(&h->buf[i])[0];
        (void)sink;
    }
    auto t1 = std::chrono::steady_clock::now();
    *elapsed_s = std::chrono::duration<double>(t1 - t0).count();
    return total;
}

// BCH decode timing: corrupt `nerr` bits of the given codeword each rep
// (same positions), decode, accumulate corrections.
long ref_bch_bench_run(int shortf, int rate, uint8_t *frame_bytes,
                       int nbytes, int nerr, int reps, double *elapsed_s) {
    BBFrameBCH b(fsz(shortf), (dvbs2_code_rate_t)rate);
    std::vector<uint8_t> work(nbytes);
    long total = 0;
    auto t0 = std::chrono::steady_clock::now();
    for (int r = 0; r < reps; ++r) {
        memcpy(work.data(), frame_bytes, nbytes);
        for (int e = 0; e < nerr; ++e) {
            int bit = (e * 2654435761u) % (nbytes * 8);
            work[bit / 8] ^= (uint8_t)(0x80 >> (bit % 8));
        }
        total += b.decode(work.data());
    }
    auto t1 = std::chrono::steady_clock::now();
    *elapsed_s = std::chrono::duration<double>(t1 - t0).count();
    return total;
}

// Viterbi steady-state timing: repeatedly run a SYNCED decoder over the
// same soft buffer (caller must have driven it to SYNCED first).
long ref_viterbi_bench_run(void *h, int8_t *soft, int size, uint8_t *out,
                           int reps, double *elapsed_s) {
    Viterbi_DVBS *v = (Viterbi_DVBS *)h;
    long produced = 0;
    auto t0 = std::chrono::steady_clock::now();
    for (int r = 0; r < reps; ++r)
        produced += v->work(soft, size, out);
    auto t1 = std::chrono::steady_clock::now();
    *elapsed_s = std::chrono::duration<double>(t1 - t0).count();
    return produced;
}

// RS(204,188) timing over a frame of 8 packets with nerr byte errors each.
long ref_rs_bench_run(uint8_t *frames1632, int nerr, int reps,
                      double *elapsed_s) {
    static dsp::dvbs::DVBSReedSolomon rs;
    std::vector<uint8_t> work(1632);
    long total = 0;
    auto t0 = std::chrono::steady_clock::now();
    for (int r = 0; r < reps; ++r) {
        memcpy(work.data(), frames1632, 1632);
        for (int p = 0; p < 8; ++p)
            for (int e = 0; e < nerr; ++e)
                work[p * 204 + (e * 97) % 204] ^= 0x55;
        for (int p = 0; p < 8; ++p)
            total += rs.decode(&work[p * 204]);
    }
    auto t1 = std::chrono::steady_clock::now();
    *elapsed_s = std::chrono::duration<double>(t1 - t0).count();
    return total;
}

}  // extern "C"
