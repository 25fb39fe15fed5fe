// Golden-oracle harness: builds the REFERENCE decoders (via the csdr shim)
// into a stdin->stdout tool so digiham_jax's decoders can be compared
// byte-for-byte against the original implementation.
//
// Usage: ref_harness <dmr|ysf|nxdn|dstar|pocsag> [metadata-file]
//   stdin:  symbol stream (one symbol per byte, dibits 0-3 or bits 0/1)
//   stdout: payload bytes exactly as the reference emits them
//   metadata-file: reference FileMetaWriter events (k:v;..\n)
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <unistd.h>

#include "csdr/reader.hpp"
#include "csdr/writer.hpp"

#include "decoder.hpp"
#include "meta.hpp"
#include "dmr_decoder.hpp"
#include "ysf_decoder.hpp"
#include "nxdn_decoder.hpp"
#include "dstar_decoder.hpp"
#include "pocsag_decoder.hpp"

namespace {

class VectorReader: public Csdr::Reader<unsigned char> {
    public:
        explicit VectorReader(std::vector<unsigned char> d): data(std::move(d)) {}
        size_t available() override { return data.size() - pos; }
        unsigned char* getReadPointer() override { return data.data() + pos; }
        void advance(size_t n) override { pos += n; }
    private:
        std::vector<unsigned char> data;
        size_t pos = 0;
};

class VectorWriter: public Csdr::Writer<unsigned char> {
    public:
        VectorWriter() { data.resize(1 << 20); }
        size_t writeable() override { return data.size() - fill; }
        unsigned char* getWritePointer() override {
            if (data.size() - fill < (1 << 16)) data.resize(data.size() * 2);
            return data.data() + fill;
        }
        void advance(size_t n) override { fill += n; }
        std::vector<unsigned char> data;
        size_t fill = 0;
};

}  // namespace

int main(int argc, char** argv) {
    if (argc < 2) {
        fprintf(stderr, "usage: %s <dmr|ysf|nxdn|dstar|pocsag> [metafile]\n",
                argv[0]);
        return 2;
    }
    std::string proto = argv[1];

    Digiham::Decoder* decoder = nullptr;
    if (proto == "dmr") decoder = new Digiham::Dmr::Decoder();
    else if (proto == "ysf") decoder = new Digiham::Ysf::Decoder();
    else if (proto == "nxdn") decoder = new Digiham::Nxdn::Decoder();
    else if (proto == "dstar") decoder = new Digiham::DStar::Decoder();
    else if (proto == "pocsag") decoder = new Digiham::Pocsag::Decoder();
    else { fprintf(stderr, "unknown protocol\n"); return 2; }

    if (argc > 2) {
        FILE* mf = fopen(argv[2], "w");
        if (!mf) { perror("metafile"); return 2; }
        decoder->setMetaWriter(new Digiham::FileMetaWriter(mf));
    }

    std::vector<unsigned char> input;
    unsigned char buf[65536];
    ssize_t n;
    while ((n = read(0, buf, sizeof(buf))) > 0) {
        input.insert(input.end(), buf, buf + n);
    }

    auto* reader = new VectorReader(std::move(input));
    auto* writer = new VectorWriter();
    decoder->setReader(reader);
    decoder->setWriter(writer);

    while (decoder->canProcess()) {
        decoder->process();
    }

    fwrite(writer->data.data(), 1, writer->fill, stdout);
    fflush(stdout);
    delete decoder;
    return 0;
}
