// Host-staged collectives: a c10d Backend for ranks that share one card.
//
// NCCL refuses two ranks on one device, and gloo's own CUDA path hangs in
// the functional collectives that DTensor issues (PERF.md §6).  This
// backend takes each collective's CUDA tensors, copies them to host memory,
// runs the same collective on the gloo backend it wraps (made by the caller,
// parallel/staged.py) and copies the results back to the tensors' device.
// Every call is synchronous: it returns a completed Work, so the results are
// in place, on the caller's stream, when it returns.  Registered for the
// "cuda" device beside gloo for "cpu" ("cpu:gloo,cuda:staged").  Host
// tensors pass through untouched (the tests register it for "cpu").
//
// Bound by the host: two copies over PCIe (through pinned buffers) and
// gloo's ring over TCP between the processes on one machine.  No TPU kernel is replaced: the reference
// runs its collectives inside XLA.
#include <torch/csrc/distributed/c10d/Backend.hpp>
#include <torch/csrc/distributed/c10d/Work.hpp>
#include <torch/csrc/utils/pybind.h>

namespace {

using c10d::Backend;
using c10d::OpType;
using c10d::Work;
using Tensors = std::vector<at::Tensor>;

class DoneWork : public Work {
 public:
  explicit DoneWork(OpType op) : Work(-1, op) {}
  bool isCompleted() override { return true; }
  bool wait(std::chrono::milliseconds /*timeout*/) override { return true; }
  c10::intrusive_ptr<c10::ivalue::Future> getFuture() override {
    auto f = c10::make_intrusive<c10::ivalue::Future>(c10::NoneType::get());
    f->markCompleted(c10::IValue());
    return f;
  }
};

// A contiguous host buffer shaped as t: for a device tensor, pinned memory
// from torch's caching host allocator, so that a collective neither
// page-faults fresh memory in nor copies at pageable speed.
at::Tensor host_buffer(const at::Tensor& t) {
  return at::empty(t.sizes(),
                   t.options().device(at::kCPU).pinned_memory(!t.is_cpu()));
}

// A contiguous host tensor holding t's values (t itself when it is one).
at::Tensor host(const at::Tensor& t) {
  if (t.is_cpu()) {
    return t.contiguous();
  }
  auto h = host_buffer(t);
  h.copy_(t);
  return h;
}

// A contiguous host tensor shaped as t, for a collective's output (t itself
// when it is one).
at::Tensor host_out(const at::Tensor& t) {
  if (t.is_cpu() && t.is_contiguous()) {
    return t;
  }
  return host_buffer(t);
}

Tensors hosts(const Tensors& ts) {
  Tensors out;
  out.reserve(ts.size());
  for (const auto& t : ts) {
    out.push_back(host(t));
  }
  return out;
}

Tensors host_outs(const Tensors& ts) {
  Tensors out;
  out.reserve(ts.size());
  for (const auto& t : ts) {
    out.push_back(host_out(t));
  }
  return out;
}

void back(at::Tensor& dst, const at::Tensor& h) {
  if (!dst.is_same(h)) {
    dst.copy_(h);
  }
}

void back(Tensors& dst, const Tensors& h) {
  for (size_t i = 0; i < dst.size(); ++i) {
    back(dst[i], h[i]);
  }
}

class Staged : public Backend {
 public:
  Staged(c10::intrusive_ptr<Backend> inner, int rank, int size)
      : Backend(rank, size), inner_(std::move(inner)) {}

  const std::string getBackendName() const override { return "staged"; }

  c10::intrusive_ptr<Work> broadcast(
      Tensors& ts, const c10d::BroadcastOptions& o) override {
    auto h = hosts(ts);
    inner_->broadcast(h, o)->wait();
    back(ts, h);
    return done(OpType::BROADCAST);
  }

  c10::intrusive_ptr<Work> allreduce(
      Tensors& ts, const c10d::AllreduceOptions& o) override {
    auto h = hosts(ts);
    inner_->allreduce(h, o)->wait();
    back(ts, h);
    return done(OpType::ALLREDUCE);
  }

  c10::intrusive_ptr<Work> allreduce_coalesced(
      Tensors& ts, const c10d::AllreduceCoalescedOptions& o) override {
    auto h = hosts(ts);
    inner_->allreduce_coalesced(h, o)->wait();
    back(ts, h);
    return done(OpType::ALLREDUCE_COALESCED);
  }

  c10::intrusive_ptr<Work> reduce(
      Tensors& ts, const c10d::ReduceOptions& o) override {
    auto h = hosts(ts);
    inner_->reduce(h, o)->wait();
    back(ts, h);
    return done(OpType::REDUCE);
  }

  c10::intrusive_ptr<Work> allgather(
      std::vector<Tensors>& outs, Tensors& ins,
      const c10d::AllgatherOptions& o) override {
    auto hi = hosts(ins);
    std::vector<Tensors> ho;
    for (const auto& l : outs) {
      ho.push_back(host_outs(l));
    }
    inner_->allgather(ho, hi, o)->wait();
    for (size_t i = 0; i < outs.size(); ++i) {
      back(outs[i], ho[i]);
    }
    return done(OpType::ALLGATHER);
  }

  c10::intrusive_ptr<Work> _allgather_base(
      at::Tensor& out, at::Tensor& in,
      const c10d::AllgatherOptions& o) override {
    auto hi = host(in);
    auto ho = host_out(out);
    inner_->_allgather_base(ho, hi, o)->wait();
    back(out, ho);
    return done(OpType::_ALLGATHER_BASE);
  }

  c10::intrusive_ptr<Work> allgather_into_tensor_coalesced(
      Tensors& outs, Tensors& ins, const c10d::AllgatherOptions& o) override {
    for (size_t i = 0; i < outs.size(); ++i) {
      _allgather_base(outs[i], ins[i], o);
    }
    return done(OpType::COALESCED);
  }

  c10::intrusive_ptr<Work> gather(
      std::vector<Tensors>& outs, Tensors& ins,
      const c10d::GatherOptions& o) override {
    auto hi = hosts(ins);
    std::vector<Tensors> ho;
    for (const auto& l : outs) {
      ho.push_back(host_outs(l));
    }
    inner_->gather(ho, hi, o)->wait();
    for (size_t i = 0; i < outs.size(); ++i) {
      back(outs[i], ho[i]);
    }
    return done(OpType::GATHER);
  }

  c10::intrusive_ptr<Work> scatter(
      Tensors& outs, std::vector<Tensors>& ins,
      const c10d::ScatterOptions& o) override {
    auto ho = host_outs(outs);
    std::vector<Tensors> hi;
    for (const auto& l : ins) {
      hi.push_back(hosts(l));
    }
    inner_->scatter(ho, hi, o)->wait();
    back(outs, ho);
    return done(OpType::SCATTER);
  }

  c10::intrusive_ptr<Work> reduce_scatter(
      Tensors& outs, std::vector<Tensors>& ins,
      const c10d::ReduceScatterOptions& o) override {
    auto ho = host_outs(outs);
    std::vector<Tensors> hi;
    for (const auto& l : ins) {
      hi.push_back(hosts(l));
    }
    inner_->reduce_scatter(ho, hi, o)->wait();
    back(outs, ho);
    return done(OpType::REDUCE_SCATTER);
  }

  c10::intrusive_ptr<Work> _reduce_scatter_base(
      at::Tensor& out, at::Tensor& in,
      const c10d::ReduceScatterOptions& o) override {
    auto hi = host(in);
    auto ho = host_out(out);
    inner_->_reduce_scatter_base(ho, hi, o)->wait();
    back(out, ho);
    return done(OpType::_REDUCE_SCATTER_BASE);
  }

  c10::intrusive_ptr<Work> reduce_scatter_tensor_coalesced(
      Tensors& outs, Tensors& ins,
      const c10d::ReduceScatterOptions& o) override {
    for (size_t i = 0; i < outs.size(); ++i) {
      _reduce_scatter_base(outs[i], ins[i], o);
    }
    return done(OpType::COALESCED);
  }

  c10::intrusive_ptr<Work> alltoall_base(
      at::Tensor& out, at::Tensor& in, std::vector<int64_t>& out_splits,
      std::vector<int64_t>& in_splits,
      const c10d::AllToAllOptions& o) override {
    auto hi = host(in);
    auto ho = host_out(out);
    inner_->alltoall_base(ho, hi, out_splits, in_splits, o)->wait();
    back(out, ho);
    return done(OpType::ALLTOALL_BASE);
  }

  c10::intrusive_ptr<Work> alltoall(
      Tensors& outs, Tensors& ins, const c10d::AllToAllOptions& o) override {
    auto hi = hosts(ins);
    auto ho = host_outs(outs);
    inner_->alltoall(ho, hi, o)->wait();
    back(outs, ho);
    return done(OpType::ALLTOALL);
  }

  c10::intrusive_ptr<Work> send(Tensors& ts, int dst, int tag) override {
    auto h = hosts(ts);
    inner_->send(h, dst, tag)->wait();
    return done(OpType::SEND);
  }

  c10::intrusive_ptr<Work> recv(Tensors& ts, int src, int tag) override {
    auto h = host_outs(ts);
    inner_->recv(h, src, tag)->wait();
    back(ts, h);
    return done(OpType::RECV);
  }

  c10::intrusive_ptr<Work> barrier(const c10d::BarrierOptions& o) override {
    inner_->barrier(o)->wait();
    return done(OpType::BARRIER);
  }

 private:
  static c10::intrusive_ptr<Work> done(OpType op) {
    return c10::make_intrusive<DoneWork>(op);
  }

  c10::intrusive_ptr<Backend> inner_;
};

}  // namespace

PYBIND11_MODULE(staged_backend, m) {
  m.def(
      "create",
      [](c10::intrusive_ptr<Backend> inner, int rank, int size)
          -> c10::intrusive_ptr<Backend> {
        return c10::make_intrusive<Staged>(std::move(inner), rank, size);
      },
      "The staged backend over the gloo backend `inner` of the same group.");
}
