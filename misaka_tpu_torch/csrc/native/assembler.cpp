// Native TIS assembler: tokenizer + dense-table lowering in C++.
//
// Functional twin of misaka_tpu/tis/parser.py + lower.py (which mirror the
// reference's internal/tis/tokenizer.go grammar branch for branch).  Exposed
// as a C ABI for ctypes; used by the runtime for fast /load of large
// programs and as the seed of the native host-runtime layer.  Parity with
// the Python frontend is enforced by tests/test_native.py (corpus + fuzz).
//
// Build: make native   (g++ -O2 -std=c++17 -shared -fPIC)

#include <cstdint>
#include <cstring>
#include <map>
#include <regex>
#include <string>
#include <vector>

namespace {

// --- ISA constants: must match misaka_tpu/tis/isa.py ------------------------
enum Op {
  OP_NOP = 0, OP_SWP = 1, OP_SAV = 2, OP_NEG = 3,
  OP_MOV_LOCAL = 4, OP_MOV_NET = 5, OP_ADD = 6, OP_SUB = 7,
  OP_JMP = 8, OP_JEZ = 9, OP_JNZ = 10, OP_JGZ = 11, OP_JLZ = 12,
  OP_JRO = 13, OP_PUSH = 14, OP_POP = 15, OP_IN = 16, OP_OUT = 17,
};
enum Src { SRC_IMM = 0, SRC_ACC = 1, SRC_NIL = 2, SRC_R0 = 3 };
enum Dst { DST_ACC = 0, DST_NIL = 1 };
enum Field { F_OP = 0, F_SRC, F_IMM, F_DST, F_TGT, F_PORT, F_JMP, NFIELDS };

// --- grammar (tokenizer.go:41-101; \w kept ASCII as in Go) ------------------
const std::regex kLabel("^\\s*([0-9A-Za-z_]+):");
const std::regex kPrefix("^(\\s*[0-9A-Za-z_]+:)?\\s*");
const std::regex kComment("^#.*$");
const std::regex kNullary("^(NOP|SWP|SAV|NEG)\\s*$");
const std::regex kMovValLocal("^MOV\\s+(-?\\d+)\\s*,\\s+(ACC|NIL)\\s*$");
const std::regex kMovValNet("^MOV\\s+(-?\\d+)\\s*,\\s+([0-9A-Za-z_]+:R[0123])\\s*$");
const std::regex kMovSrcLocal("^MOV\\s+(ACC|NIL|R[0123])\\s*,\\s+(ACC|NIL)\\s*$");
const std::regex kMovSrcNet("^MOV\\s+(ACC|NIL|R[0123])\\s*,\\s+([0-9A-Za-z_]+:R[0123])\\s*$");
const std::regex kAddSubVal("^(ADD|SUB)\\s+(-?\\d+)\\s*$");
const std::regex kAddSubSrc("^(ADD|SUB)\\s+(ACC|NIL|R[0123])\\s*$");
const std::regex kJump("^(JMP|JEZ|JNZ|JGZ|JLZ)\\s+([0-9A-Za-z_]+)\\s*$");
const std::regex kJroVal("^JRO\\s+(-?\\d+)\\s*$");
const std::regex kJroSrc("^JRO\\s+(ACC|NIL|R[0123])\\s*$");
const std::regex kPushVal("^PUSH\\s+(-?\\d+)\\s*,\\s+([0-9A-Za-z_]+)\\s*$");
const std::regex kPushSrc("^PUSH\\s+(ACC|NIL|R[0123])\\s*,\\s+([0-9A-Za-z_]+)\\s*$");
const std::regex kPop("^POP\\s+([0-9A-Za-z_]+)\\s*,\\s+(ACC|NIL)\\s*$");
const std::regex kIn("^IN\\s+(ACC|NIL)\\s*$");
const std::regex kOutVal("^OUT\\s+(-?\\d+)\\s*$");
const std::regex kOutSrc("^OUT\\s+(ACC|NIL|R[0123])\\s*$");

std::string upper(const std::string& s) {
  std::string r = s;
  for (auto& c : r) c = toupper((unsigned char)c);
  return r;
}

int32_t parse_i32(const std::string& text) {
  // Python-side wrap semantics: value mod 2^32 into int32 range.
  long long v = strtoll(text.c_str(), nullptr, 10);
  return (int32_t)(uint64_t)v;
}

int src_sel(const std::string& tok) {
  if (tok == "ACC") return SRC_ACC;
  if (tok == "NIL") return SRC_NIL;
  return SRC_R0 + (tok[1] - '0');  // R0..R3
}

std::vector<std::string> split_lines(const std::string& text) {
  std::vector<std::string> out;
  size_t start = 0;
  while (true) {
    size_t nl = text.find('\n', start);
    if (nl == std::string::npos) {
      out.push_back(text.substr(start));
      break;
    }
    out.push_back(text.substr(start, nl - start));
    start = nl + 1;
  }
  return out;
}

std::map<std::string, int> name_map(const char* joined) {
  std::map<std::string, int> m;
  if (!joined || !*joined) return m;
  int i = 0;
  for (auto& name : split_lines(joined)) {
    if (!name.empty()) m[name] = i++;
  }
  return m;
}

struct Error {
  std::string msg;
};

}  // namespace

extern "C" {

// Source-identity tag scanned from the .so bytes by utils/nativelib.py to
// detect a binary built from different source (mtime comparison cannot —
// a fresh checkout gives every file the same timestamp).  The build injects
// -DMISAKA_SRC_HASH=<sha256[:16] of this file>.
#ifndef MISAKA_SRC_HASH
#define MISAKA_SRC_HASH "unbuilt"
#endif
__attribute__((used)) const char misaka_src_hash_tag[] =
    "MISAKA-SRC-HASH:" MISAKA_SRC_HASH;

// Assemble `program` into out_code[max_lines * NFIELDS] (row-major).
// Returns the number of lines, or -1 with `err` filled.
int misaka_assemble(const char* program, const char* lane_names,
                    const char* stack_names, int32_t* out_code, int max_lines,
                    char* err, int err_cap) {
  auto fail = [&](const std::string& m) {
    if (err && err_cap > 0) {
      strncpy(err, m.c_str(), err_cap - 1);
      err[err_cap - 1] = 0;
    }
    return -1;
  };

  auto lanes = name_map(lane_names);
  auto stacks = name_map(stack_names);
  auto lines = split_lines(program ? program : "");
  if ((int)lines.size() > max_lines) return fail("program too long");

  // pass 1: label map (tokenizer.go:11-26)
  std::map<std::string, int> label_map;
  for (size_t i = 0; i < lines.size(); i++) {
    std::smatch m;
    if (std::regex_search(lines[i], m, kLabel)) {
      std::string label = upper(m[1].str());
      if (label_map.count(label)) return fail("Cannot repeat label");
      label_map[label] = (int)i;
    }
  }

  // pass 2: tokenize + lower in one sweep
  for (size_t i = 0; i < lines.size(); i++) {
    int32_t* f = out_code + i * NFIELDS;
    memset(f, 0, NFIELDS * sizeof(int32_t));
    std::string instr = lines[i];
    std::smatch pm;
    if (std::regex_search(instr, pm, kPrefix)) instr = pm.suffix().str();

    std::smatch m;
    auto line_err = [&](const std::string& what) {
      return fail("line " + std::to_string(i) + ", " + what);
    };

    if (instr.empty() || std::regex_match(instr, m, kComment)) {
      f[F_OP] = OP_NOP;
    } else if (std::regex_match(instr, m, kNullary)) {
      const std::string t = m[1].str();
      f[F_OP] = t == "NOP" ? OP_NOP : t == "SWP" ? OP_SWP
                : t == "SAV" ? OP_SAV : OP_NEG;
    } else if (std::regex_match(instr, m, kMovValLocal)) {
      f[F_OP] = OP_MOV_LOCAL;
      f[F_SRC] = SRC_IMM;
      f[F_IMM] = parse_i32(m[1].str());
      f[F_DST] = m[2].str() == "ACC" ? DST_ACC : DST_NIL;
    } else if (std::regex_match(instr, m, kMovValNet) ||
               std::regex_match(instr, m, kMovSrcLocal) ||
               std::regex_match(instr, m, kMovSrcNet)) {
      // disambiguate which matched (regex_match left `m` from the first hit)
      std::smatch mv;
      if (std::regex_match(instr, mv, kMovValNet)) {
        f[F_OP] = OP_MOV_NET;
        f[F_SRC] = SRC_IMM;
        f[F_IMM] = parse_i32(mv[1].str());
        std::string tgt = mv[2].str();
        size_t colon = tgt.find(':');
        std::string name = tgt.substr(0, colon);
        if (!lanes.count(name))
          return line_err("'" + name + "' is not a program node on this network");
        f[F_TGT] = lanes[name];
        f[F_PORT] = tgt[colon + 2] - '0';
      } else if (std::regex_match(instr, mv, kMovSrcLocal)) {
        f[F_OP] = OP_MOV_LOCAL;
        f[F_SRC] = src_sel(mv[1].str());
        f[F_DST] = mv[2].str() == "ACC" ? DST_ACC : DST_NIL;
      } else {
        std::regex_match(instr, mv, kMovSrcNet);
        f[F_OP] = OP_MOV_NET;
        f[F_SRC] = src_sel(mv[1].str());
        std::string tgt = mv[2].str();
        size_t colon = tgt.find(':');
        std::string name = tgt.substr(0, colon);
        if (!lanes.count(name))
          return line_err("'" + name + "' is not a program node on this network");
        f[F_TGT] = lanes[name];
        f[F_PORT] = tgt[colon + 2] - '0';
      }
    } else if (std::regex_match(instr, m, kAddSubVal)) {
      f[F_OP] = m[1].str() == "ADD" ? OP_ADD : OP_SUB;
      f[F_SRC] = SRC_IMM;
      f[F_IMM] = parse_i32(m[2].str());
    } else if (std::regex_match(instr, m, kAddSubSrc)) {
      f[F_OP] = m[1].str() == "ADD" ? OP_ADD : OP_SUB;
      f[F_SRC] = src_sel(m[2].str());
    } else if (std::regex_match(instr, m, kJump)) {
      std::string label = upper(m[2].str());
      if (!label_map.count(label))
        return line_err("label '" + label + "' was not declared");
      const std::string t = m[1].str();
      f[F_OP] = t == "JMP" ? OP_JMP : t == "JEZ" ? OP_JEZ
                : t == "JNZ" ? OP_JNZ : t == "JGZ" ? OP_JGZ : OP_JLZ;
      f[F_JMP] = label_map[label];
    } else if (std::regex_match(instr, m, kJroVal)) {
      f[F_OP] = OP_JRO;
      f[F_SRC] = SRC_IMM;
      f[F_IMM] = parse_i32(m[1].str());
    } else if (std::regex_match(instr, m, kJroSrc)) {
      f[F_OP] = OP_JRO;
      f[F_SRC] = src_sel(m[1].str());
    } else if (std::regex_match(instr, m, kPushVal) ||
               std::regex_match(instr, m, kPushSrc)) {
      std::smatch pv;
      f[F_OP] = OP_PUSH;
      std::string tgt;
      if (std::regex_match(instr, pv, kPushVal)) {
        f[F_SRC] = SRC_IMM;
        f[F_IMM] = parse_i32(pv[1].str());
        tgt = pv[2].str();
      } else {
        std::regex_match(instr, pv, kPushSrc);
        f[F_SRC] = src_sel(pv[1].str());
        tgt = pv[2].str();
      }
      if (!stacks.count(tgt))
        return line_err("'" + tgt + "' is not a stack node on this network");
      f[F_TGT] = stacks[tgt];
    } else if (std::regex_match(instr, m, kPop)) {
      f[F_OP] = OP_POP;
      std::string tgt = m[1].str();
      if (!stacks.count(tgt))
        return line_err("'" + tgt + "' is not a stack node on this network");
      f[F_TGT] = stacks[tgt];
      f[F_DST] = m[2].str() == "ACC" ? DST_ACC : DST_NIL;
    } else if (std::regex_match(instr, m, kIn)) {
      f[F_OP] = OP_IN;
      f[F_DST] = m[1].str() == "ACC" ? DST_ACC : DST_NIL;
    } else if (std::regex_match(instr, m, kOutVal)) {
      f[F_OP] = OP_OUT;
      f[F_SRC] = SRC_IMM;
      f[F_IMM] = parse_i32(m[1].str());
    } else if (std::regex_match(instr, m, kOutSrc)) {
      f[F_OP] = OP_OUT;
      f[F_SRC] = src_sel(m[1].str());
    } else {
      return line_err("'" + instr + "' not a valid instruction");
    }
  }

  return (int)lines.size();
}

}  // extern "C"
