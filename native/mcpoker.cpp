// mcpoker: native host runtime for the interactive table path.
//
// The reference's runtime is JVM actor loops (core.async go-loops + STM,
// board.clj:131-138 / player.clj:58-69). The rebuild's batch path is
// the JAX device engine; THIS file is the native equivalent of the
// reference's per-table runtime for the latency-sensitive interactive
// server: a single-table Texas Hold'em engine with the exact same betting
// semantics (validated against the JAX engine and the Python oracle in
// tests/test_native.py), plus the bitmask 7-card evaluator producing the
// same packed uint32 hand key.
//
// Semantics mirror the Clojure reference code (citations inline):
//   - layered bets with ordered split/insert (bet.clj:45-59), adjacent
//     coalescing keeping the later layer's n (bet.clj:10-27)
//   - fold = member removal + filter from play-order (board.clj:33-44)
//   - call threads the full standing total; exact-equality all-in removes
//     the seat from :players (board.clj:45-71)
//   - raise threads r + total and resets remaining-players
//     (board.clj:72-97)
//   - street/hand end rules (gameplay.clj:15-24), street transitions
//     (gameplay.clj:94-102), integer pot splits with the inflated n
//     (gameplay.clj:104-116)
//
// C ABI only; bound from Python with ctypes (montecarlo_tpu/native.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxSeats = 23;  // 52 cards / 2 - board; practical bound

// ---------------------------------------------------------------------------
// Hand evaluation: packed key == handval.py (4-bit category, five 4-bit
// ranks in the reference's hit-then-kicker compare order).
// ---------------------------------------------------------------------------

inline int msb(uint32_t x) { return x ? 31 - __builtin_clz(x) : -1; }

inline uint32_t pack(uint32_t cat, int r0, int r1, int r2, int r3, int r4) {
  return (cat << 20) | (uint32_t(r0) << 16) | (uint32_t(r1) << 12) |
         (uint32_t(r2) << 8) | (uint32_t(r3) << 4) | uint32_t(r4);
}

inline int pop_msb(uint32_t &m) {
  int p = msb(m);
  if (p >= 0) m &= ~(1u << p);
  return p < 0 ? 0 : p;
}

uint32_t eval_masks(uint32_t m0, uint32_t m1, uint32_t m2, uint32_t m3) {
  uint32_t present = m0 | m1 | m2 | m3;
  uint32_t c2p = (m0 & m1) | (m0 & m2) | (m0 & m3) | (m1 & m2) | (m1 & m3) |
                 (m2 & m3);
  uint32_t c3p = (m0 & m1 & m2) | (m0 & m1 & m3) | (m0 & m2 & m3) |
                 (m1 & m2 & m3);
  uint32_t c4 = m0 & m1 & m2 & m3;
  uint32_t trips = c3p & ~c4;
  uint32_t pairs = c2p & ~c3p;

  auto run5_top = [](uint32_t s) {
    uint32_t r = s & (s >> 1) & (s >> 2) & (s >> 3) & (s >> 4);
    return r ? msb(r) + 4 : -1;
  };

  int straight_top = run5_top(present);
  uint32_t fmask = 0;
  for (uint32_t m : {m0, m1, m2, m3})
    if (__builtin_popcount(m) >= 5) fmask = m;
  int sf_top = run5_top(fmask);

  if (sf_top >= 0)
    return pack(8, sf_top, sf_top - 1, sf_top - 2, sf_top - 3, sf_top - 4);
  if (c4) {
    int q = msb(c4);
    int k = msb(present & ~(1u << q));
    return pack(7, q, q, q, q, k < 0 ? 0 : k);
  }
  bool fh = trips && (pairs || __builtin_popcount(trips) >= 2);
  if (fh) {
    int t = msb(trips);
    int p = msb((trips | pairs) & ~(1u << t));
    return pack(6, t, t, t, p, p);
  }
  if (fmask) {
    uint32_t m = fmask;
    int a = pop_msb(m), b = pop_msb(m), c = pop_msb(m), d = pop_msb(m),
        e = pop_msb(m);
    return pack(5, a, b, c, d, e);
  }
  if (straight_top >= 0)
    return pack(4, straight_top, straight_top - 1, straight_top - 2,
                straight_top - 3, straight_top - 4);
  if (trips) {
    int t = msb(trips);
    uint32_t m = present & ~(1u << t);
    int k1 = pop_msb(m), k2 = pop_msb(m);
    return pack(3, t, t, t, k1, k2);
  }
  if (__builtin_popcount(pairs) >= 2) {
    uint32_t m = pairs;
    int hp = pop_msb(m), lp = pop_msb(m);
    int k = msb(present & ~(1u << hp) & ~(1u << lp));
    return pack(2, hp, hp, lp, lp, k < 0 ? 0 : k);
  }
  if (pairs) {
    int p = msb(pairs);
    uint32_t m = present & ~(1u << p);
    int k1 = pop_msb(m), k2 = pop_msb(m), k3 = pop_msb(m);
    return pack(1, p, p, k1, k2, k3);
  }
  uint32_t m = present;
  int a = pop_msb(m), b = pop_msb(m), c = pop_msb(m), d = pop_msb(m),
      e = pop_msb(m);
  return pack(0, a, b, c, d, e);
}

uint32_t eval_cards(const int32_t *cards, int k) {
  uint32_t m[4] = {0, 0, 0, 0};
  for (int i = 0; i < k; ++i) {
    int c = cards[i];
    m[c / 13] |= 1u << (2 + c % 13);
  }
  return eval_masks(m[0], m[1], m[2], m[3]);
}

// Comparison-only key: C++ twin of ops/evaluator.py eval_masks_cmp_impl
// (the key used inside the Pallas equity/engine kernels). Bit-exact vs the
// JAX implementation (pinned in tests/test_native.py); its order
// isomorphism with the packed reference key is certified exhaustively over
// all C(52,7) hands by native/certify_evaluator.cpp.
inline uint32_t keep_top(uint32_t mask, int n, int max_clears) {
  for (int i = 0; i < max_clears; ++i)
    if (__builtin_popcount(mask) > n) mask &= mask - 1;
  return mask;
}

uint32_t eval_masks_cmp(uint32_t m0, uint32_t m1, uint32_t m2, uint32_t m3) {
  uint32_t present = m0 | m1 | m2 | m3;
  uint32_t c2p = (m0 & m1) | (m0 & m2) | (m0 & m3) | (m1 & m2) | (m1 & m3) |
                 (m2 & m3);
  uint32_t c3p = (m0 & m1 & m2) | (m0 & m1 & m3) | (m0 & m2 & m3) |
                 (m1 & m2 & m3);
  uint32_t c4 = m0 & m1 & m2 & m3;
  uint32_t trips = c3p & ~c4;
  uint32_t pairs = c2p & ~c3p;

  auto run5_top = [](uint32_t s) {
    uint32_t r = s & (s >> 1) & (s >> 2) & (s >> 3) & (s >> 4);
    return r ? msb(r) + 4 : -1;
  };
  int straight_top = run5_top(present);
  uint32_t fmask = 0;
  for (uint32_t m : {m0, m1, m2, m3})
    if (__builtin_popcount(m) >= 5) fmask = m;
  int sf_top = run5_top(fmask);

  int q = std::max(msb(c4), 0);
  int qk = std::max(msb(present & ~(1u << q)), 0);
  int t_fh = std::max(msb(trips), 0);
  int p_fh = std::max(msb((trips | pairs) & ~(1u << t_fh)), 0);
  uint32_t trips_kick = keep_top(present & ~(1u << t_fh), 2, 2);
  uint32_t top2_pairs = keep_top(pairs, 2, 1);
  int tp_kick = std::max(msb(present & ~top2_pairs), 0);
  int p1 = std::max(msb(pairs), 0);
  uint32_t pair_kick = keep_top(present & ~(1u << p1), 3, 2);

  if (sf_top >= 0) return (8u << 19) | uint32_t(sf_top);
  if (c4) return (7u << 19) | (uint32_t(q) << 4) | uint32_t(qk);
  if (trips && (pairs || __builtin_popcount(trips) >= 2))
    return (6u << 19) | (uint32_t(t_fh) << 4) | uint32_t(p_fh);
  if (fmask) return (5u << 19) | keep_top(fmask, 5, 2);
  if (straight_top >= 0) return (4u << 19) | uint32_t(straight_top);
  if (trips) return (3u << 19) | (uint32_t(t_fh) << 15) | trips_kick;
  if (__builtin_popcount(pairs) >= 2)
    return (2u << 19) | (top2_pairs << 4) | uint32_t(tp_kick);
  if (pairs) return (1u << 19) | (uint32_t(p1) << 15) | pair_kick;
  return keep_top(present, 5, 2);
}

uint32_t eval_cards_cmp(const int32_t *cards, int k) {
  uint32_t m[4] = {0, 0, 0, 0};
  for (int i = 0; i < k; ++i) {
    int c = cards[i];
    m[c / 13] |= 1u << (2 + c % 13);
  }
  return eval_masks_cmp(m[0], m[1], m[2], m[3]);
}

// ---------------------------------------------------------------------------
// Bet layers (player sets as seat bitmasks).
// ---------------------------------------------------------------------------

struct Bet {
  int32_t amount;
  uint32_t players;
  uint32_t orig;
  int32_t n;
};

void update_bets(std::vector<Bet> &bets, int32_t amt, int seat) {
  // bet.clj:45-59
  uint32_t pb = 1u << seat;
  std::vector<Bet> out;
  out.reserve(bets.size() + 1);
  size_t i = 0;
  int32_t bet = amt;
  for (; i < bets.size(); ++i) {
    Bet s = bets[i];
    if (bet < s.amount) {
      out.push_back({bet, s.players | pb, s.orig | pb, s.n + 1});
      out.push_back({s.amount - bet, s.players, s.orig, s.n});
      out.insert(out.end(), bets.begin() + i + 1, bets.end());
      bets = std::move(out);
      return;
    }
    out.push_back({s.amount, s.players | pb, s.orig | pb, s.n + 1});
    if (bet == s.amount) {
      out.insert(out.end(), bets.begin() + i + 1, bets.end());
      bets = std::move(out);
      return;
    }
    bet -= s.amount;
  }
  out.push_back({bet, pb, pb, 1});
  bets = std::move(out);
}

void merge_bets(std::vector<Bet> &bets) {
  // bet.clj:10-27 — the later layer's n wins.
  std::vector<Bet> out;
  for (const Bet &b : bets) {
    if (!out.empty() && out.back().players == b.players &&
        out.back().orig == b.orig) {
      out.back().amount += b.amount;
      out.back().n = b.n;
    } else {
      out.push_back(b);
    }
  }
  bets = std::move(out);
}

// ---------------------------------------------------------------------------
// Table engine.
// ---------------------------------------------------------------------------

struct Table {
  int n = 0;
  int32_t small = 5, big = 10;
  int32_t deck[52];
  int32_t hole[kMaxSeats][2];
  int32_t community[5];
  int32_t stacks[kMaxSeats];
  std::vector<Bet> bets, pots;
  uint32_t in_hand = 0, remaining = 0;
  std::vector<int> order;  // play-order base list (seat ids, fold-filtered)
  int cursor = 0;
  int stage = 0, time = 0, n_revealed = 0;
  bool over = false;

  int32_t total_bet() const {
    int32_t t = 0;
    for (const Bet &b : bets) t += b.amount;
    return t;
  }
  int32_t needed(int seat) const {
    int32_t t = 0;
    for (const Bet &b : bets)
      if (!(b.players >> seat & 1u)) t += b.amount;
    return t;
  }
  int head() const { return order.empty() ? -1 : order[cursor % order.size()]; }

  void order_rest() { cursor = int(cursor % order.size()) + 1; }
  void order_remove_head() {
    int j = int(cursor % order.size());
    order.erase(order.begin() + j);
    cursor = j;
  }

  bool stage_end() const { return remaining == 0; }
  bool game_end() const {
    return __builtin_popcount(in_hand) <= 1 || (stage_end() && stage == 3);
  }

  void stage_transition() {  // gameplay.clj:94-102
    n_revealed += stage == 0 ? 3 : 1;
    remaining = in_hand;
    pots.insert(pots.end(), bets.begin(), bets.end());
    bets.clear();
    order.clear();
    for (int s = 0; s < n; ++s)
      if (in_hand >> s & 1u) order.push_back(s);
    cursor = 0;
    ++stage;
  }

  int32_t clamp(int32_t action) const {  // player.clj:28-32
    if (action <= 0) return action;
    int p = head();
    return std::max(0, std::min(action, stacks[p] - needed(p)));
  }

  void act(int32_t action) {  // board.clj:31-97 + board-action :122-129
    if (over) return;
    int p = head();
    uint32_t pb = 1u << p;
    ++time;
    if (action < 0) {  // fold
      for (Bet &b : bets) b.players &= ~pb;
      merge_bets(bets);
      remaining &= ~pb;
      order_remove_head();
      in_hand &= ~pb;
    } else if (action == 0) {  // call / check
      int32_t amt = total_bet();
      if (amt > 0) {
        int32_t delta = needed(p);
        if (delta == stacks[p]) in_hand &= ~pb;  // all-in exact equality
        stacks[p] -= delta;
        update_bets(bets, amt, p);
      } else {
        merge_bets(bets);
      }
      order_rest();
      remaining &= ~pb;
    } else {  // raise by r
      int32_t r = action;
      int32_t delta = needed(p);
      if (delta + r == stacks[p]) {
        in_hand &= ~pb;
        stacks[p] = 0;
      } else {
        stacks[p] -= delta + r;
      }
      update_bets(bets, r + total_bet(), p);
      order_rest();
      remaining = in_hand & ~pb;
    }
    if (game_end())
      over = true;
    else if (stage_end())
      stage_transition();
  }

  void settle() {  // gameplay.clj:104-133 (empty-winner pots pay nobody)
    pots.insert(pots.end(), bets.begin(), bets.end());
    bets.clear();
    uint32_t values[kMaxSeats];
    for (int s = 0; s < n; ++s) {
      int32_t cards[7] = {hole[s][0], hole[s][1], community[0], community[1],
                          community[2], community[3], community[4]};
      values[s] = eval_cards(cards, 7);
    }
    for (const Bet &pot : pots) {
      uint32_t elig = pot.players & in_hand;
      if (!elig) continue;
      uint32_t best = 0;
      for (int s = 0; s < n; ++s)
        if (elig >> s & 1u) best = std::max(best, values[s]);
      int cnt = 0;
      for (int s = 0; s < n; ++s)
        if ((elig >> s & 1u) && values[s] == best) ++cnt;
      int32_t share = (pot.amount * pot.n) / cnt;
      for (int s = 0; s < n; ++s)
        if ((elig >> s & 1u) && values[s] == best) stacks[s] += share;
    }
    over = true;
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

uint32_t mc_eval7(const int32_t *cards) { return eval_cards(cards, 7); }
uint32_t mc_eval5(const int32_t *cards) { return eval_cards(cards, 5); }

void mc_eval7_batch(const int32_t *cards, int64_t n, uint32_t *out) {
  for (int64_t i = 0; i < n; ++i) out[i] = eval_cards(cards + 7 * i, 7);
}

uint32_t mc_eval7_cmp(const int32_t *cards) { return eval_cards_cmp(cards, 7); }

void mc_eval7_cmp_batch(const int32_t *cards, int64_t n, uint32_t *out) {
  for (int64_t i = 0; i < n; ++i) out[i] = eval_cards_cmp(cards + 7 * i, 7);
}

Table *mc_table_new(int32_t n, int32_t small, int32_t big,
                    const int32_t *deck, const int32_t *stacks) {
  if (n < 2 || n > kMaxSeats) return nullptr;
  Table *t = new Table();
  t->n = n;
  t->small = small;
  t->big = big;
  std::memcpy(t->deck, deck, 52 * sizeof(int32_t));
  for (int s = 0; s < n; ++s) t->stacks[s] = stacks ? stacks[s] : 100;
  // deal-hand (gameplay.clj:63-75) + burn offsets (:30-54); seat == hand
  // order position here (the host maps seats to player ids).
  for (int j = 0; j < n; ++j) {
    t->hole[j][0] = deck[j];
    t->hole[j][1] = deck[n + j];
  }
  int base = 2 * n;
  t->community[0] = deck[base + 1];
  t->community[1] = deck[base + 2];
  t->community[2] = deck[base + 3];
  t->community[3] = deck[base + 5];
  t->community[4] = deck[base + 7];
  t->in_hand = t->remaining = (n >= 32 ? ~0u : (1u << n) - 1u);
  for (int s = 0; s < n; ++s) t->order.push_back(s);
  // play-blinds (gameplay.clj:77-88)
  t->stacks[0] -= small;
  update_bets(t->bets, small, 0);
  t->stacks[1] -= big;
  update_bets(t->bets, big, 1);
  t->cursor = 2 % n;
  return t;
}

void mc_table_free(Table *t) { delete t; }

int32_t mc_table_clamp(const Table *t, int32_t action) {
  return t->clamp(action);
}

void mc_table_act(Table *t, int32_t action) { t->act(t->clamp(action)); }
void mc_table_act_raw(Table *t, int32_t action) { t->act(action); }
void mc_table_settle(Table *t) { t->settle(); }

// Overwrite live stacks (hand-order space): the reference's stacks are
// global per-player refs (database.clj:8-12) mutated by any room, so a
// cross-room stack change is visible to an in-progress hand immediately.
// Chips already contributed to this hand's layers were deducted at bet
// time, so the incoming value is simply the new spendable stack.
void mc_table_set_stacks(Table *t, const int32_t *stacks) {
  for (int s = 0; s < t->n; ++s) t->stacks[s] = stacks[s];
}

// Flat snapshot for conformance tests:
// [n, stage, time, n_revealed, over, head, in_hand, remaining,
//  stacks[n], n_bets, bets(4 ints each), n_pots, pots(4 ints each)]
int32_t mc_table_snapshot(const Table *t, int32_t *buf, int32_t cap) {
  std::vector<int32_t> v;
  v.push_back(t->n);
  v.push_back(t->stage);
  v.push_back(t->time);
  v.push_back(t->n_revealed);
  v.push_back(t->over ? 1 : 0);
  v.push_back(t->over ? -1 : t->head());
  v.push_back(int32_t(t->in_hand));
  v.push_back(int32_t(t->remaining));
  for (int s = 0; s < t->n; ++s) v.push_back(t->stacks[s]);
  v.push_back(int32_t(t->bets.size()));
  for (const Bet &b : t->bets) {
    v.push_back(b.amount);
    v.push_back(int32_t(b.players));
    v.push_back(int32_t(b.orig));
    v.push_back(b.n);
  }
  v.push_back(int32_t(t->pots.size()));
  for (const Bet &b : t->pots) {
    v.push_back(b.amount);
    v.push_back(int32_t(b.players));
    v.push_back(int32_t(b.orig));
    v.push_back(b.n);
  }
  // play-order internals (for the host's public play-order window)
  v.push_back(t->order.empty() ? 0
                               : int32_t(t->cursor % t->order.size()));
  v.push_back(int32_t(t->order.size()));
  for (int s : t->order) v.push_back(s);
  if (int32_t(v.size()) > cap) return -int32_t(v.size());
  std::memcpy(buf, v.data(), v.size() * sizeof(int32_t));
  return int32_t(v.size());
}

}  // extern "C"
